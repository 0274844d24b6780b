"""K5, the block engine's previous-smaller pass (``block_psv``), and the
match types built on it (``nsv_left``): the port's plain versions against
the JAX package's ``psac_tpu/ops/bansv.py``, the sequential oracle
``ansv_seq`` and, as an independent check, the doubling descent of
``ops/nsv_scan.py``.  int32 and int64 values; sizes below one block,
exactly one block, across blocks and across superblocks.  Exact equality
(integers only).  The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py, which needs a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import psac_tpu.ops.bansv as j_bansv
import psac_tpu_torch.ops.bansv as t_bansv
from psac_tpu.models.suffix_array import _x64_ctx
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     NONSV, ansv_seq)
from psac_tpu_torch.ops.nsv_scan import _min_table, _prev_lt

torch.set_num_threads(1)

TYPES = [NEAREST_SM, NEAREST_EQ, FURTHEST_EQ]
DTYPES = {"int32": np.int32, "int64": np.int64}


# jitted: one compile per shape instead of one per eager op
_J_PSV = jax.jit(j_bansv.block_psv, static_argnums=1)
_J_NSV = jax.jit(j_bansv.nsv_left, static_argnums=1)


def _cases(seed: int, sizes, dt) -> dict:
    """Random small alphabets, plateaus, monotone runs and a sawtooth; the
    int64 cases are scaled by an order-preserving map out of int32."""
    rng = np.random.RandomState(seed)
    out = {}
    for n in sizes:
        saw = np.arange(n)
        saw[::2] = 10**6 - saw[::2]
        for name, a in (("rand", rng.randint(0, 5, n)), ("const", np.full(n, 7)),
                        ("inc", np.arange(n)), ("dec", n - np.arange(n)),
                        ("saw", saw)):
            a = a.astype(np.int64)
            if dt == np.int64:
                a = a * (1 << 33) - (1 << 40)
            out[f"{name}{n}"] = a.astype(dt)
    return out


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_block_psv_plain_vs_jax(dt, strict):
    cases = _cases(1, (1, 100, 256, 257, 1000), DTYPES[dt])
    # two superblocks (65536 elements each)
    big = _cases(1, (66000,), DTYPES[dt])
    cases.update((k, big[k]) for k in ("rand66000", "saw66000"))
    for name, a in cases.items():
        x = torch.from_numpy(a)
        got = t_bansv.block_psv(x, strict)  # CPU tensor: the plain version
        assert got.dtype == torch.int32, name
        with _x64_ctx(jnp.int64 if dt == "int64" else jnp.int32):
            want = np.asarray(_J_PSV(jnp.asarray(a), strict))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        i = torch.arange(len(a))
        desc = _prev_lt(_min_table(x), i, x, strict)
        np.testing.assert_array_equal(got.numpy(), desc.numpy(), err_msg=name)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("typ", TYPES)
def test_nsv_left_vs_jax_and_oracle(typ, dt):
    for name, a in _cases(2, (1, 255, 256, 257, 3000), DTYPES[dt]).items():
        idx, val = t_bansv.nsv_left(torch.from_numpy(a), typ)
        with _x64_ctx(jnp.int64 if dt == "int64" else jnp.int32):
            j_idx, j_val = _J_NSV(jnp.asarray(a), typ)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx),
                                      err_msg=name)
        np.testing.assert_array_equal(val.numpy(), np.asarray(j_val),
                                      err_msg=name)
        assert val.dtype == torch.from_numpy(a).dtype
        want, _ = ansv_seq(a, typ, typ)
        got = idx.numpy().astype(np.int64)
        got[got < 0] = NONSV
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("typ", TYPES)
def test_small_blocks_reach_every_stage(typ, monkeypatch):
    """Block width 4 on both sides: the superblock search, the distant-
    block rows and several chunks of the all-pairs and resolve stages run
    on small inputs."""
    for mod in (j_bansv, t_bansv):
        monkeypatch.setattr(mod, "B", 4)
        monkeypatch.setattr(mod, "_BC", 8)
        monkeypatch.setattr(mod, "_QMIN", 8)
    j_nsv = jax.jit(j_bansv.nsv_left, static_argnums=1)  # traced with B = 4
    rng = np.random.RandomState(12)
    for n in (3, 16, 17, 64, 65, 257, 1000):
        for a in (rng.randint(0, 4, n), np.full(n, 3),
                  rng.randint(0, 1000, n)):
            a = a.astype(np.int32)
            idx, val = t_bansv.nsv_left(torch.from_numpy(a), typ)
            j_idx, j_val = j_nsv(jnp.asarray(a), typ)
            np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(val.numpy(), np.asarray(j_val))
            want, _ = ansv_seq(a, typ, typ)
            got = idx.numpy().astype(np.int64)
            got[got < 0] = NONSV
            np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_other_dtypes():
    with pytest.raises(ValueError):
        t_bansv.block_psv(torch.zeros(8, dtype=torch.int16, device="meta"),
                          True)
