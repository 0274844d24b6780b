"""K8, the hierarchical-window walks (``ops/walk.py``): the plain versions
and the public wrappers on CPU tensors against the JAX package's
``psac_tpu.ops.walk`` on numpy-seeded inputs (``verify/cases.walk_case``),
a numpy model of the kernel (``csrc/walk.cu``: phase A's window, phase
B's group walk) against the same at the built shape and the sweep's
others, and the ANSV's walks through ``AnsvKernels``: the p = 1 ``walk``
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

#: (vectors in phase A's window, lanes per query in phase B, vectors per
#: lane in phase B's window) of the kernel as built (PSAC_K8_WINDOW_A,
#: PSAC_K8_GROUP, PSAC_K8_WINDOW) and of the other shapes that
#: tools/k8_sweep.py builds; a window of 0 reads the whole range in one
#: round, and phase A's of 0 sends every query to phase B
SHAPE = (8, 8, 1)
SHAPES = [(0, 8, 0), (0, 8, 1), (8, 8, 0), (4, 8, 1), (16, 8, 1),
          (8, 4, 2), (8, 16, 1)]


def _lane_best(rows, v, a, b, lo, hi, strict, last, vec, G, count):
    """``lane_best``: (q, G) of each lane's last (first) qualifying offset
    in [lo, hi] over its vectors a + g, a + g + G, ... (``count`` of them,
    those <= b); -1 (T) when none."""
    q = rows.shape[0]
    c = a[:, None, None] + np.arange(G)[None, :, None] \
        + G * np.arange(count)[None, None, :]
    live = c <= b[:, None, None]
    assert (c[live] >= 0).all() and (c[live] < T // vec).all()
    j = c[..., None] * vec + np.arange(vec)
    ent = rows[np.arange(q)[:, None, None, None], np.clip(j, 0, T - 1)]
    vv = v[:, None, None, None]
    qual = ((ent < vv) if strict else (ent <= vv)) & live[..., None] \
        & (j >= lo[:, None, None, None]) & (j <= hi[:, None, None, None])
    if last:
        return np.where(qual, j, -1).max(axis=(2, 3))
    return np.where(qual, j, T).min(axis=(2, 3))


def _group_best(best, last: bool):
    """``group_best``: log2(G) xor-shuffle steps; every lane ends with the
    same."""
    G = best.shape[1]
    o = G // 2
    while o:
        other = best[:, np.arange(G) ^ o]
        best = np.maximum(best, other) if last else np.minimum(best, other)
        o //= 2
    assert (best == best[:, :1]).all()
    return best[:, 0]


def _find(rows, v, lo, hi, strict, last, vec, G, wpl):
    """``find`` of phase B: the last (first) qualifying offset of each row
    in [lo, hi] (lo <= hi) with G lanes, the window of G * wpl vectors next
    to the near end first and the rest of the searched side only where the
    window has none; -1 (T) when none."""
    R = T // vec
    lo, hi = np.broadcast_to(lo, v.shape), np.broadcast_to(hi, v.shape)
    if wpl == 0:
        return _group_best(_lane_best(rows, v, lo // vec, hi // vec, lo, hi,
                                      strict, last, vec, G, -(-R // G)), last)
    WV = G * wpl
    wlo = np.maximum(hi // vec - WV + 1, 0) if last else \
        np.minimum(lo // vec, R - WV)
    best = _group_best(_lane_best(rows, v, wlo, wlo + WV - 1, lo, hi, strict,
                                  last, vec, G, wpl), last)
    miss = best < 0 if last else best >= T
    a = lo // vec if last else wlo + WV
    b = wlo - 1 if last else hi // vec
    rest = miss & (a <= b)
    if rest.any():
        r = np.nonzero(rest)[0]
        best = best.copy()
        best[r] = _group_best(_lane_best(
            rows[r], v[r], a[r], b[r], lo[r], hi[r], strict, last, vec, G,
            -(-(R - WV) // G)), last)
    return best


def _window_a(row, v, pos, strict, nxt, vec, WA):
    """``window_answer`` of phase A, one thread a query: the bit mask of
    the WA vectors of the own row that end (prev_lt) or start at the own
    position, on its searched side; (found, offset)."""
    R = T // vec
    wlo = np.minimum(pos // vec, R - WA) if nxt else \
        np.maximum(pos // vec - WA + 1, 0)
    bits = np.arange(WA * vec)
    ent = row[np.arange(row.shape[0])[:, None], wlo[:, None] * vec + bits]
    lim = pos - wlo * vec
    assert ((lim >= 0) & (lim < WA * vec)).all()
    qual = (ent < v[:, None]) if strict else (ent <= v[:, None])
    qual &= (bits >= lim[:, None]) if nxt else (bits <= lim[:, None])
    b = np.where(qual, bits, WA * vec).min(axis=1) if nxt else \
        np.where(qual, bits, -1).max(axis=1)
    return qual.any(axis=1), wlo * vec + b


def _k8_model(levels, start, v, strict: bool, nxt: bool, shape=SHAPE,
              stats=None):
    """The kernel's walk, vectorized over queries.  Phase A answers from
    its window where it can; phase B takes the rest with G lanes: the own
    level-0 row without the window, then the ascent, which skips a row with
    no entry on the searched side and stops at the first level with a hit
    (queries that hit leave the batch), and the descent, which takes the
    last (first) qualifying child; every row read clamped.  ``stats``
    counts the queries phase A answers from its window and those it
    leaves."""
    WA, G, wpl = shape
    levels = [lv.numpy() for lv in levels]
    vec = 4 if levels[0].dtype == np.int32 else 2
    R = T // vec
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
    pos0 = own & (T - 1)
    if WA:
        idx = np.nonzero(active)[0]
        parent = own[idx] >> 7
        found, b = _window_a(levels[0][np.clip(parent, 0, rows[0] - 1)],
                             v[idx], pos0[idx], strict, nxt, vec, WA)
        level[idx[found]] = 0
        node[idx[found]] = parent[found] * T + b[found]
        if stats is not None:
            stats["window"] += int(found.sum())
            stats["rest"] += int((~found).sum())
        # phase B's level-0 range: the searched side without the window
        wlo = np.minimum(pos0 // vec, R - WA) if nxt else \
            np.maximum(pos0 // vec - WA + 1, 0)
        lo0 = (wlo + WA) * vec if nxt else np.zeros(q, np.int64)
        hi0 = np.full(q, T - 1) if nxt else wlo * vec - 1
    else:
        lo0 = pos0 if nxt else np.zeros(q, np.int64)
        hi0 = np.full(q, T - 1) if nxt else pos0
    for k in range(len(levels)):
        pos = own & (T - 1)
        if k == 0:
            lo, hi = lo0, hi0
        elif nxt:
            lo, hi = pos + 1, np.full(q, T - 1)
        else:
            lo, hi = np.zeros(q, np.int64), pos - 1
        idx = np.nonzero(active & (level < 0) & (lo <= hi))[0]
        parent = own[idx] >> 7
        row = levels[k][np.clip(parent, 0, rows[k] - 1)]
        b = _find(row, v[idx], lo[idx], hi[idx], strict, not nxt, vec, G,
                  wpl)
        found = b < T if nxt else b >= 0
        level[idx[found]] = k
        node[idx[found]] = parent[found] * T + b[found]
        own = own >> 7
    for k in range(len(levels) - 1, 0, -1):
        idx = np.nonzero(level >= k)[0]
        row = levels[k - 1][np.clip(node[idx], 0, rows[k - 1] - 1)]
        b = _find(row, v[idx], 0, T - 1, strict, not nxt, vec, G, wpl)
        b = np.where(b < T, b, T - 1) if nxt else np.where(b >= 0, b, 0)
        node[idx] = node[idx] * T + b
    return np.where(level >= 0, node, s if nxt else -1)


def _model_vs_jax(kind, n, dtype, shape):
    x, start, v, levels = _case(kind, n, dtype)
    want = _jax_answers(kind, n, dtype)
    stats = {"window": 0, "rest": 0}
    for name in ("prev_lt", "next_leq"):
        for strict in (True, False):
            got = _k8_model(levels, start, v, strict, name == "next_leq",
                            shape, stats)
            np.testing.assert_array_equal(got, want[name, strict])
    return stats


@pytest.mark.parametrize("kind,n,dtype", CASES, ids=map(_ids, CASES))
def test_kernel_model_vs_jax(kind, n, dtype):
    """The model of K8 as built (phase A's 128-byte window, then 8 lanes a
    query with 128-byte windows) equals the JAX walks on every case; on the
    ``near`` cases above one row phase A answers most queries."""
    stats = _model_vs_jax(kind, n, dtype, SHAPE)
    if kind == "near" and n > T:
        assert stats["window"] > 2 * stats["rest"], stats


SHAPE_CASES = [(shape, *c) for shape in SHAPES for c in CASES]


@pytest.mark.parametrize(
    "shape,kind,n,dtype", SHAPE_CASES,
    ids=[f"A{c[0][0]}G{c[0][1]}w{c[0][2]}-{_ids(c[1:])}"
         for c in SHAPE_CASES])
def test_kernel_model_shapes_vs_jax(shape, kind, n, dtype):
    """The same at the other shapes the sweep builds: phase A's window of
    64, 128 or 256 bytes or none, 4, 8 or 16 lanes in phase B, its windows
    of 128 or 256 bytes or none."""
    _model_vs_jax(kind, n, dtype, shape)


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
