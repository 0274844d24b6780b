"""The port's suffix-array checks against the JAX package's
(``psac_tpu/verify/check_sa.py``): the host property checks on the same
arrays, and ``d_check_sa`` on the CPU against the JAX ``d_check_sa`` at
p = 1 on the same padded device states, for a correct SA, two swapped
rows, a duplicated row, repetitive text and an int64 index."""

import dataclasses

import numpy as np
import pytest
import torch

from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.verify import check_sa as t_check

torch.set_num_threads(1)

TEXTS = {
    "dna": rand_dna(1500, seed=11),
    "rep_dna": rep_dna(2500, unit_len=300, seed=2, mutations=3),
    "mississippi": b"mississippi",
}


def _corrupt(sa: np.ndarray, how: str, off: int = 0) -> np.ndarray:
    """``sa`` as given, with two real rows swapped, or with one real row's
    value duplicated into another."""
    sa = sa.copy()
    a, b = off + 1, off + 2
    if how == "swapped":
        sa[a], sa[b] = sa[b], sa[a]
    elif how == "duplicated":
        sa[b] = sa[a]
    return sa


@pytest.mark.parametrize("how", ["correct", "swapped", "duplicated"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_host_checks_vs_jax(name, how):
    from psac_tpu.verify import check_sa as j_check

    from psac_tpu_torch import native

    text = TEXTS[name]
    sa = _corrupt(native.suffix_array(text), how)
    lcp = native.lcp_array(text, native.suffix_array(text))
    got = t_check.check_sa_np(text, sa)
    assert got == j_check.check_sa_np(text, sa)
    assert got == (how == "correct")
    assert t_check.check_lcp_np(text, sa, lcp) == \
        j_check.check_lcp_np(text, sa, lcp)
    assert t_check.check_lcp_np(text, native.suffix_array(text), lcp)
    bad = lcp.copy()
    bad[-1] += 1
    assert not t_check.check_lcp_np(text, native.suffix_array(text), bad)
    assert t_check.check_sa_np(b"", np.zeros(0, np.int64))


@pytest.mark.parametrize("force_int64", [False, True])
@pytest.mark.parametrize("how", ["correct", "swapped", "duplicated"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_d_check_sa_vs_jax(mesh1, name, how, force_int64):
    import jax
    import jax.numpy as jnp
    import psac_tpu.config as j_cfg
    from psac_tpu.models import suffix_array as j_sa
    from psac_tpu.verify import check_sa as j_check

    from psac_tpu_torch import SAConfig
    from psac_tpu_torch.models import suffix_array as t_sa

    text = TEXTS[name]
    conf = SAConfig(force_int64=force_int64)
    xs, alpha, n, N = t_sa.encode_and_shard(text, "cpu")
    dsa = t_sa.construct_device(xs, alpha, n, N, conf)
    assert dsa.sa.dtype == (torch.int64 if force_int64 else torch.int32)
    sa = _corrupt(dsa.sa.numpy(), how, off=N - n)
    tdsa = dataclasses.replace(dsa, sa=torch.from_numpy(sa))
    got = t_check.d_check_sa(tdsa, xs)
    assert got == (how == "correct")

    jconf = dataclasses.replace(j_cfg.DEFAULT, force_int64=force_int64)
    jxs, jalpha, _, _ = j_sa.encode_and_shard(text, mesh1, jconf)
    jdsa = j_sa.construct_device(jxs, jalpha, n, N, mesh1, jconf)
    np.testing.assert_array_equal(np.asarray(jax.device_get(jdsa.sa)),
                                  dsa.sa.numpy())
    with j_sa._x64_ctx(jdsa.sa.dtype):
        want = j_check.d_check_sa(
            dataclasses.replace(jdsa, sa=jnp.asarray(sa)), jxs)
    assert got == want


def test_d_check_sa_rejects_out_of_range_values():
    from psac_tpu_torch.models import suffix_array as t_sa

    text = rand_dna(900, seed=4)
    xs, alpha, n, N = t_sa.encode_and_shard(text, "cpu")
    dsa = t_sa.construct_device(xs, alpha, n, N)
    assert t_check.d_check_sa(dsa, xs)
    for v in (n, -1, 2 * N):
        sa = dsa.sa.clone()
        sa[N - n + 5] = v
        assert not t_check.d_check_sa(dataclasses.replace(dsa, sa=sa), xs)


def test_d_check_sa_on_a_file_build(tmp_path):
    from psac_tpu_torch.models.suffix_array import construct_from_file

    f = tmp_path / "t.txt"
    f.write_bytes(rep_dna(3000, unit_len=200, seed=1, mutations=2))
    dsa, xs = construct_from_file(str(f), "cpu")
    assert t_check.d_check_sa(dsa, xs)
