"""The host arrays (``models.suffix_array.host_int64``) on the CPU: every
kind of source the three ``materialize`` methods hand it (a tensor, a
``Sharded`` array; int32 and int64; 1-D arrays and a 2-D node table; a
cut of 0 and of N - n) gives the rows the plain cut-and-widen gives, in
a new writable int64 array that shares no memory with its source; and
``DeviceSuffixArray``, ``DeviceGSA`` and ``DeviceSuffixTree`` materialize
the JAX package's device arrays as its own ``materialize`` does.  The
card's path (the widen on the card, the DMA into pinned blocks, their
reuse) is held in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from psac_tpu_torch.models import gsa as t_gsa
from psac_tpu_torch.models import suffix_array as t_sa
from psac_tpu_torch.models import suffix_tree as t_st
from psac_tpu_torch.ops.alphabet import rand_dna
from psac_tpu_torch.parallel.mesh import Sharded

torch.set_num_threads(1)

WIDTH = 5  # a DNA suffix tree's sigma + 1 slots


@pytest.mark.parametrize("n", [0, 1, 4099])
@pytest.mark.parametrize("pad", [0, 61], ids=["cut0", "cutNn"])
@pytest.mark.parametrize("width", [1, WIDTH], ids=["1d", "table"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("kind", ["tensor", "sharded"])
def test_host_int64_vs_plain(kind, dtype, width, pad, n):
    N = n + pad
    rng = np.random.RandomState(n + 7 * pad + width)
    x = torch.from_numpy(rng.randint(1, 1 << 30, N * width)).to(dtype)
    before = x.clone()
    want = (x if width == 1 else x.view(N, width))[pad:].numpy().astype(
        np.int64)
    src = Sharded(torch.tensor_split(x, 3)) if kind == "sharded" else x
    (got,) = t_sa.host_int64(src, cut=pad, width=width)
    assert got.dtype == np.int64 and got.shape == want.shape
    assert got.flags.c_contiguous and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    # a result is the caller's own: writing into it (the LCP's row 0
    # included) leaves the source as it was
    got[...] = -1
    if n:
        got.reshape(n, width)[0] = 0
    assert torch.equal(x, before)
    # None stays None, in its place
    a, none, b = t_sa.host_int64(src, None, src, cut=pad, width=width)
    assert none is None
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(b, want)


def _jax_sa(text, mesh1, int64: bool):
    from psac_tpu.config import SAConfig as JaxSAConfig
    from psac_tpu.models.suffix_array import (construct_device,
                                              encode_and_shard)

    jcfg = JaxSAConfig(force_int64=int64)
    xs, alpha, n, N = encode_and_shard(text, mesh1, jcfg)
    return construct_device(xs, alpha, n, N, mesh1, jcfg), xs


def _np(a):
    import jax

    return np.asarray(jax.device_get(a))


TEXT = rand_dna(3001, seed=27)
PARTS = [b"ACGTACGA", b"TTACG", b"ACGTAC", b"G", b"CATCATCAT"]


@pytest.mark.parametrize("int64", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("what", ["suffix_array", "gsa", "suffix_tree"])
def test_materialize_vs_jax(mesh1, what, int64):
    """Each ``materialize`` of the JAX package's device arrays, carried over
    as numpy arrays, equals the JAX package's own and is the caller's:
    writing into it leaves the device state as it was."""
    if what == "gsa":
        from psac_tpu.config import SAConfig as JaxSAConfig
        from psac_tpu.models.gsa import build_gsa_device

        jd = build_gsa_device(PARTS, mesh=mesh1,
                              config=JaxSAConfig(force_int64=int64))
        sa, lcp, eos, xs = (_np(a) for a in (jd.sa, jd.lcp, jd.eos, jd.xs))
        dev = t_gsa.DeviceGSA.from_numpy(sa, lcp, eos, xs, jd.alphabet,
                                         jd.lens, jd.n, jd.N, "cpu")
    else:
        jd, jxs = _jax_sa(TEXT, mesh1, int64)
        dev = t_sa.DeviceSuffixArray.from_numpy(
            _np(jd.sa), _np(jd.lcp), _np(jd.isa), jd.alphabet, jd.n, jd.N,
            "cpu")
    assert dev.sa.dtype == (torch.int64 if int64 else torch.int32)
    state = {k: getattr(dev, k).clone() for k in ("sa", "lcp")}
    if what == "suffix_tree":
        from psac_tpu.models.suffix_tree import construct_suffix_tree_device

        want = construct_suffix_tree_device(jd, jxs, mesh1).materialize()
        xs_t, *_ = t_sa.encode_and_shard(TEXT, "cpu")
        tree = t_st.construct_suffix_tree_device(dev, xs_t)
        nodes = tree.nodes.clone()
        got = tree.materialize()
        assert got.dtype == np.int64 and got.flags.writeable
        np.testing.assert_array_equal(got, want)
        got[...] = -1
        assert torch.equal(tree.nodes, nodes)
    else:
        want, got = jd.materialize(), dev.materialize()
        for name in ("sa", "lcp"):
            g = getattr(got, name)
            assert g.dtype == np.int64 and g.flags.writeable, name
            np.testing.assert_array_equal(g, getattr(want, name),
                                          err_msg=name)
            g[...] = -1
        assert want.lcp[0] == 0
    for k, v in state.items():
        assert torch.equal(getattr(dev, k), v), k

