"""K8, the hierarchical-window walks (``ops/walk.py``): the plain versions
and the public wrappers on CPU tensors against the JAX package's
``psac_tpu.ops.walk`` on numpy-seeded inputs (``verify/cases.walk_case``),
a numpy model of the kernel's group walk (``csrc/walk.cu``) against the
same, and the ANSV's walks through ``AnsvKernels``: the p = 1 ``walk``
engine and ``ansv_mesh_local`` at p = 2 against the JAX ``ansv_local``.
Exact equality (integers only)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from psac_tpu.ops import walk as j_walk
from psac_tpu.parallel.mesh import AXIS, block_sharding
from psac_tpu.parallel.mesh import make_mesh as j_make_mesh
from psac_tpu_torch.ops import walk as t_walk
from psac_tpu_torch.ops.ansv import (FURTHEST_EQ, NEAREST_EQ, NEAREST_SM,
                                     ansv_seq)
from psac_tpu_torch.parallel import ansv as t_ansv
from psac_tpu_torch.parallel.mesh import Rep, make_mesh
from psac_tpu_torch.verify import cases

torch.set_num_threads(1)

T = 128
# n = 1 and 127-129 around one row; 2^21 + 1 gives four levels
SIZES = [1, 127, 128, 129, (1 << 21) + 1]
Q = 1500


def x64(wide: bool):
    """The JAX package's scoped x64 context for int64 values."""
    from psac_tpu.models.suffix_array import _x64_ctx

    return _x64_ctx(jnp.int64 if wide else jnp.int32)


@functools.lru_cache(maxsize=None)
def _case(kind: str, n: int, dtype: str):
    x, start, v = cases.walk_case(kind, n, np.dtype(dtype), Q, seed=n)
    return x, start, v, t_walk.build_levels(torch.from_numpy(x))


@functools.lru_cache(maxsize=None)
def _jax_answers(kind: str, n: int, dtype: str) -> dict:
    """The JAX walks' answers for both functions and both ``strict``."""
    x, start, v, _ = _case(kind, n, dtype)
    out = {}
    with x64(dtype == "int64"):
        levels = j_walk.build_levels(jnp.asarray(x))
        for name, fn in (("prev_lt", j_walk.levels_prev_lt),
                         ("next_leq", j_walk.levels_next_leq)):
            for strict in (True, False):
                out[name, strict] = np.asarray(fn(
                    levels, jnp.asarray(start, jnp.int32), jnp.asarray(v),
                    strict=strict))
    return out


CASES = [(k, n, dt) for dt in ("int32", "int64") for n in SIZES
         for k in cases.WALK_KINDS]


def _ids(c):
    return f"{c[0]}-{c[1]}-{c[2]}"


@pytest.mark.parametrize("kind,n,dtype", CASES, ids=map(_ids, CASES))
def test_walks_vs_jax_cases(kind, n, dtype):
    """The plain walks and the wrappers (on CPU tensors: the plain
    versions, no launch counted) equal the JAX walks, strict and not, on
    starts 0, n, the padded length and random ones, and on values that
    include the dtype's extremes."""
    x, start, v, levels = _case(kind, n, dtype)
    want = _jax_answers(kind, n, dtype)
    ts, tv = torch.from_numpy(start), torch.from_numpy(v)
    before = (t_walk.levels_prev_lt.launches, t_walk.levels_next_leq.launches)
    for name in ("prev_lt", "next_leq"):
        plain = getattr(t_walk, f"levels_{name}_plain")
        wrapper = getattr(t_walk, f"levels_{name}")
        for strict in (True, False):
            got = plain(levels, ts, tv, strict)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want[name, strict])
            assert torch.equal(wrapper(levels, ts, tv, strict), got)
    assert (t_walk.levels_prev_lt.launches,
            t_walk.levels_next_leq.launches) == before


def test_levels_match_jax_at_four_levels():
    """``build_levels`` at n = 2^21 + 1 has four levels, each equal to the
    JAX package's."""
    for dtype in ("int32", "int64"):
        x, _, _, levels = _case("random", SIZES[-1], dtype)
        with x64(dtype == "int64"):
            jl = j_walk.build_levels(jnp.asarray(x))
            assert len(levels) == len(jl) == 4
            for a, b in zip(jl, levels):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_levels_of_a_view_off_a_16_byte_boundary(dtype):
    """``build_levels`` of a view that starts off a 16-byte boundary (K8
    reads rows as 16-byte words) starts every level on one, with the JAX
    package's levels."""
    x, _, _, _ = _case("runs", 128 * 40, dtype)
    host = torch.from_numpy(x)
    view = torch.cat([host[:1], host])[1:]
    assert view.data_ptr() % 16 != 0
    levels = t_walk.build_levels(view)
    assert all(lv.data_ptr() % 16 == 0 for lv in levels)
    with x64(dtype == "int64"):
        jl = j_walk.build_levels(jnp.asarray(x))
        assert len(levels) == len(jl)
        for a, b in zip(jl, levels):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_walks_without_a_query(dtype):
    """q = 0 gives an empty int64 answer, as the JAX walks do."""
    x = torch.arange(300, dtype=dtype)
    levels = t_walk.build_levels(x)
    start = torch.zeros(0, dtype=torch.int64)
    v = torch.zeros(0, dtype=dtype)
    for fn in (t_walk.levels_prev_lt, t_walk.levels_next_leq,
               t_walk.levels_prev_lt_plain, t_walk.levels_next_leq_plain):
        for strict in (True, False):
            got = fn(levels, start, v, strict)
            assert got.dtype == torch.int64 and got.shape == (0,)
    with x64(dtype == torch.int64):
        jl = j_walk.build_levels(jnp.asarray(x.numpy()))
        assert np.asarray(j_walk.levels_prev_lt(
            jl, jnp.zeros(0, jnp.int32), jnp.asarray(v.numpy()))).shape == (0,)


def test_wrappers_on_another_device_do_not_fall_back():
    """Off the CPU the wrappers launch K8 or raise: tensors on the meta
    device (neither CPU nor CUDA) are refused, never answered by the plain
    version."""
    levels = tuple(lv.to("meta") for lv in
                   t_walk.build_levels(torch.arange(300, dtype=torch.int32)))
    start = torch.zeros(5, dtype=torch.int64, device="meta")
    v = torch.zeros(5, dtype=torch.int32, device="meta")
    for fn in (t_walk.levels_prev_lt, t_walk.levels_next_leq):
        with pytest.raises(ValueError):
            fn(levels, start, v, True)


# ---------------------------------------------------------------------------
# a numpy model of the kernel (csrc/walk.cu)
# ---------------------------------------------------------------------------

G = 8  # lanes per query


def _lane_offsets(vec: int) -> np.ndarray:
    """(G, T / G): the row offset of lane g's entry m (``offset_of``)."""
    m = np.arange(T // G)[None, :]
    g = np.arange(G)[:, None]
    return (g + G * (m // vec)) * vec + m % vec


def _group_pick(rows, v, lo, hi, strict: bool, last: bool, vec: int):
    """``pick``: each lane's best qualifying offset in [lo, hi] among its
    entries, then three xor-shuffle steps; every lane ends with the same."""
    offs = _lane_offsets(vec)
    assert np.array_equal(np.sort(offs.ravel()), np.arange(T))
    ent = rows[:, offs]
    vv = v[:, None, None]
    qual = (ent < vv) if strict else (ent <= vv)
    qual &= (offs[None] >= np.asarray(lo)[..., None, None]) & \
        (offs[None] <= np.asarray(hi)[..., None, None])
    if last:
        best = np.where(qual, offs[None], -1).max(axis=2)
    else:
        best = np.where(qual, offs[None], T).min(axis=2)
    for o in (4, 2, 1):
        other = best[:, np.arange(G) ^ o]
        best = np.maximum(best, other) if last else np.minimum(best, other)
    assert (best == best[:, :1]).all()
    return best[:, 0]


def _k8_model(levels, start, v, strict: bool, nxt: bool):
    """The kernel's walk, vectorized over queries: the ascent stops at the
    first level with a hit (queries that hit leave the batch), the descent
    takes the last (first) qualifying child, row reads clamped."""
    levels = [lv.numpy() for lv in levels]
    vec = 4 if levels[0].dtype == np.int32 else 2
    rows = [lv.shape[0] for lv in levels]
    s = rows[0] * T
    q = start.shape[0]
    if nxt:
        active = start < s
        own = np.maximum(start, 0)
    else:
        active = start > 0
        own = start - 1
    level = np.full(q, -1)
    node = np.full(q, -1, np.int64)
    for k in range(len(levels)):
        idx = np.nonzero(active & (level < 0))[0]
        if idx.size == 0:
            break
        parent = own[idx] >> 7
        pos = own[idx] & (T - 1)
        row = levels[k][np.clip(parent, 0, rows[k] - 1)]
        if nxt:
            b = _group_pick(row, v[idx], pos if k == 0 else pos + 1, T - 1,
                            strict, False, vec)
            found = b < T
        else:
            b = _group_pick(row, v[idx], 0, pos if k == 0 else pos - 1,
                            strict, True, vec)
            found = b >= 0
        level[idx[found]] = k
        node[idx[found]] = parent[found] * T + b[found]
        own[idx] = parent
    for k in range(len(levels) - 1, 0, -1):
        idx = np.nonzero(level >= k)[0]
        row = levels[k - 1][np.clip(node[idx], 0, rows[k - 1] - 1)]
        b = _group_pick(row, v[idx], 0, T - 1, strict, not nxt, vec)
        b = np.where(b < T, b, T - 1) if nxt else np.where(b >= 0, b, 0)
        node[idx] = node[idx] * T + b
    return np.where(level >= 0, node, s if nxt else -1)


@pytest.mark.parametrize("kind,n,dtype", CASES, ids=map(_ids, CASES))
def test_kernel_model_vs_jax(kind, n, dtype):
    """The model of K8's group walk equals the JAX walks on every case."""
    x, start, v, levels = _case(kind, n, dtype)
    want = _jax_answers(kind, n, dtype)
    for name in ("prev_lt", "next_leq"):
        for strict in (True, False):
            got = _k8_model(levels, start, v, strict, name == "next_leq")
            np.testing.assert_array_equal(got, want[name, strict])


# ---------------------------------------------------------------------------
# the ANSV's walks through AnsvKernels
# ---------------------------------------------------------------------------

def test_plain_and_kernels_name_the_walks():
    assert t_ansv.KERNELS.walk_prev_lt is t_walk.levels_prev_lt
    assert t_ansv.KERNELS.walk_next_leq is t_walk.levels_next_leq
    assert t_ansv.PLAIN.walk_prev_lt is t_walk.levels_prev_lt_plain
    assert t_ansv.PLAIN.walk_next_leq is t_walk.levels_next_leq_plain


@pytest.mark.parametrize("lt,rt", [(FURTHEST_EQ, NEAREST_SM),
                                   (NEAREST_EQ, FURTHEST_EQ)])
def test_walk_engine_calls_the_walk_fields(lt, rt):
    """The p = 1 ``walk`` engine runs only the kernels' walk fields: two
    previous-smaller and two next walks for a furthest_eq side, one
    previous-smaller walk for any other, and answers as ``ansv_seq``."""
    from test_torch_ansv import _counting_plain

    a = np.random.RandomState(9).randint(0, 7, 3000).astype(np.int32)
    kernels, calls = _counting_plain()
    got = t_ansv.ansv(a, lt, rt, device="cpu", kernels=kernels,
                      engine="walk")
    assert calls == {"walk_prev_lt": 3, "walk_next_leq": 2}
    for g, o in zip(got, ansv_seq(a, lt, rt, nonsv=len(a))):
        np.testing.assert_array_equal(g, o)


@functools.lru_cache(maxsize=None)
def _jax_ansv_local(p: int, N: int, lt: int, rt: int, wide: bool):
    from psac_tpu.parallel.ansv import ansv_local

    mesh = j_make_mesh(p)
    return mesh, jax.jit(jax.shard_map(
        functools.partial(ansv_local, s=N // p, p=p, left_type=lt,
                          right_type=rt),
        mesh=mesh, in_specs=(P(AXIS),), out_specs=(P(AXIS),) * 4 + (P(),)))


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("lt,rt", [(FURTHEST_EQ, NEAREST_SM),
                                   (NEAREST_EQ, FURTHEST_EQ),
                                   (NEAREST_SM, NEAREST_EQ)])
def test_mesh_ansv_calls_the_walk_fields(lt, rt, wide):
    """``ansv_mesh_local`` at p = 2 with counting plain kernels calls the
    walk fields (the full-width furthest_eq walks and the routed ones) and
    still equals the JAX ``ansv_local`` in all four outputs."""
    from test_torch_ansv import _counting_plain

    p, N = 2, 2 * 160
    dtype = np.int64 if wide else np.int32
    rng = np.random.RandomState(17)
    a = np.repeat(rng.randint(0, 6, N // 5 + 1), 5)[:N]
    a[N // 2:] += 3  # the second shard's matches lie partly in the first
    a = ((a.astype(np.int64) << 34) - (1 << 40)) if wide else a
    a = a.astype(dtype)
    kernels, calls = _counting_plain()
    mesh = make_mesh(p, ["cpu"] * p)

    def run(ctx, x):
        *res, ovf = t_ansv.ansv_mesh_local(ctx, x, lt, rt, None, kernels)
        return (*res, Rep(int(ovf)))

    got = mesh.run(run, mesh.shard(torch.from_numpy(a)))
    mesh.close()
    assert calls.get("walk_prev_lt", 0) > 0
    if FURTHEST_EQ in (lt, rt):
        assert calls.get("walk_next_leq", 0) > 0
    assert "block_psv" in calls
    with x64(wide):
        jmesh, fn = _jax_ansv_local(p, N, lt, rt, wide)
        want = fn(jax.device_put(a, block_sharding(jmesh)))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.gather().numpy(), np.asarray(w))
