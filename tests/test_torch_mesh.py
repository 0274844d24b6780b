"""The port's mesh layer at p > 1 on CPU shards (``make_mesh(p, ["cpu"] *
p)``) against the JAX package's collectives under ``jax.shard_map`` on the
conftest's virtual devices, on the same seeded numpy inputs: the halos, the
doubling shift, the exclusive scans, the global prefix max and the shard
minima; the distributed sort (bitonic at p = 2, 4, 8, odd-even block
transposition at p = 3, 6) against ``np.lexsort``; ``route_apply`` (echo,
the chunked full-capacity pass, the overflow count at a forced small
capacity), ``route_scatter`` and ``bulk_rmq_local`` with its capacity
retry; and the mesh itself: a worker that raises makes ``Mesh.run`` raise,
and ``make_mesh`` never guesses a device.  Exact equality (integers
only)."""

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from psac_tpu.parallel import collectives as j_col
from psac_tpu.parallel import route as j_route
from psac_tpu.parallel.mesh import AXIS, block_sharding
from psac_tpu.parallel.mesh import make_mesh as j_make_mesh
from psac_tpu.parallel.sort import dist_sort_local as j_dist_sort
from psac_tpu_torch.ops.rmq import (build_local_rmq, query_local_rmq,
                                    rmq_mins)
from psac_tpu_torch.parallel import collectives as t_col
from psac_tpu_torch.parallel import route as t_route
from psac_tpu_torch.parallel.mesh import (Rep, Sharded, make_mesh,
                                          num_shards)
from psac_tpu_torch.parallel.par_rmq import bulk_rmq_local
from psac_tpu_torch.parallel.sort import (dist_sort_local,
                                          scatter_by_index_local)
from psac_tpu_torch.verify import cases

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def cpu_mesh(p: int):
    return make_mesh(p, ["cpu"] * p)


def port(p: int, fn, *arrays):
    """``fn(ctx, *local)`` on a CPU mesh; numpy arrays are sharded, other
    arguments passed as they are; sharded outputs come back as numpy."""
    mesh = cpu_mesh(p)
    args = [mesh.shard(torch.from_numpy(np.ascontiguousarray(a)))
            if isinstance(a, np.ndarray) else a for a in arrays]
    out = mesh.run(fn, *args)

    def back(o):
        if isinstance(o, Sharded):
            return o.gather().numpy()
        if isinstance(o, tuple):
            return tuple(back(x) for x in o)
        return o

    return back(out)


def jax_run(p: int, fn, *arrays, out_specs):
    mesh = j_make_mesh(p)
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(AXIS),) * len(arrays),
                              out_specs=out_specs))
    out = f(*(jax.device_put(a, block_sharding(mesh)) for a in arrays))
    return jax.tree_util.tree_map(np.asarray, out)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

S = 16
SHIFTS = (0, 1, 3, S - 1, S, S + 1, 2 * S + 5, 3 * S)


def _jax_collectives(x, p):
    s = x.shape[0]
    outs = [j_col.halo_from_right(x, 3, p),
            j_col.halo_from_right(x, 2 * s + 3, p, fill=7),
            j_col.halo_from_left(x, 1, p, fill=-5),
            j_col.halo_from_left(x, 4, p)]
    for d in SHIFTS:
        outs.append(j_col.global_shift_left(x, jnp.int32(d), min(d // s, p),
                                            p))
    v = jnp.sum(x)
    outs += [j_col.exscan_scalar(v, p)[None],
             j_col.exscan_scalar(x[0], p, op="max", init=-1)[None],
             j_col.exscan_scalar(x[0], p, op="min", init=1000)[None],
             j_col.global_index_base(s)[None].astype(jnp.int32),
             j_col.global_cummax(x, p),
             j_col.shard_minima(x, p)]
    return tuple(outs)


def _port_collectives(ctx, x):
    s = x.shape[0]
    outs = [t_col.halo_from_right(x, 3, ctx=ctx),
            t_col.halo_from_right(x, 2 * s + 3, 7, ctx),
            t_col.halo_from_left(x, 1, -5, ctx),
            t_col.halo_from_left(x, 4, ctx=ctx)]
    for d in SHIFTS:
        outs.append(t_col.global_shift_left(x, d, ctx))
    outs += [t_col.exscan_scalar(x.sum(dtype=x.dtype), ctx)[None],
             t_col.exscan_scalar(x[0], ctx, "max", -1)[None],
             t_col.exscan_scalar(x[0], ctx, "min", 1000)[None],
             torch.tensor([t_col.global_index_base(s, ctx)],
                          dtype=torch.int32),
             t_col.global_cummax(x, ctx),
             t_col.shard_minima(x, ctx)]
    return tuple(outs)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_collectives_vs_jax(p):
    x = np.random.RandomState(p).randint(0, 60, S * p).astype(np.int32)
    want = jax_run(p, functools.partial(_jax_collectives, p=p), x,
                   out_specs=(P(AXIS),) * (10 + len(SHIFTS)))
    got = port(p, _port_collectives, x)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"output {k}")
    # and the plain meanings
    N = S * p
    for k, d in enumerate(SHIFTS):
        sh = np.zeros(N, np.int32)
        sh[:max(0, N - d)] = x[d:]
        np.testing.assert_array_equal(got[4 + k], sh)
    np.testing.assert_array_equal(got[-2], np.maximum.accumulate(x))


def test_collectives_on_one_shard_need_no_ctx():
    x = torch.arange(10, dtype=torch.int32)
    assert torch.equal(t_col.halo_from_right(x, 3, 9),
                       torch.full((3,), 9, dtype=torch.int32))
    assert torch.equal(t_col.global_shift_left(x, 4), torch.cat(
        [x[4:], torch.zeros(4, dtype=torch.int32)]))
    assert torch.equal(t_col.global_cummax(x.flip(0)), torch.full_like(x, 9))


# ---------------------------------------------------------------------------
# distributed sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_keys", [1, 2, 3])
@pytest.mark.parametrize("p", [2, 3, 4, 6, 8])
def test_dist_sort_vs_lexsort(p, n_keys):
    """Bitonic merge-split at powers of two, odd-even block transposition
    otherwise; a unique last key (the global index) makes the order total,
    as every sort of the construction is."""
    N = 24 * p
    rng = np.random.RandomState(10 * p + n_keys)
    ks = [rng.randint(0, 7, N).astype(np.int32) for _ in range(n_keys)]
    gidx = rng.permutation(N).astype(np.int32)
    arrays = (*ks, gidx)

    def fn(ctx, *xs):
        return dist_sort_local(xs, n_keys + 1, ctx)

    got = port(p, fn, *arrays)
    order = np.lexsort((gidx, *reversed(ks)))
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g, a[order])
    if p in (2, 4, 8):
        want = jax_run(p, lambda *xs: j_dist_sort(xs, n_keys + 1, p), *arrays,
                       out_specs=(P(AXIS),) * len(arrays))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("p", [3, 8])
def test_scatter_by_index(p):
    N = 16 * p
    rng = np.random.RandomState(3)
    perm = rng.permutation(N).astype(np.int32)
    vals = rng.randint(0, 1000, N).astype(np.int32)
    (got,) = port(p, lambda ctx, d, v: scatter_by_index_local(d, (v,), ctx),
                  perm, vals)
    want = np.empty(N, np.int32)
    want[perm] = vals
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _echo(ctx, pay, dst, sk, cap, with_ovf):
    def answer(recv, valid):
        (v,) = recv
        return (torch.where(valid, v * 10 + ctx.rank, -1),)

    out = t_route.route_apply((pay,), answer, sk, dest=dst, ctx=ctx, cap=cap,
                              with_overflow=with_ovf)
    if with_ovf:
        (ans,), ovf = out
        return ans, Rep(int(ovf))
    return out[0]


@pytest.mark.parametrize("p", [2, 4, 8])
def test_route_apply_echo(p):
    N = 8 * p
    rng = np.random.RandomState(7)
    payload = rng.randint(0, 100, N).astype(np.int32)
    dest = rng.randint(0, p, N).astype(np.int32)
    skip = np.zeros(N, bool)
    got = port(p, _echo, payload, dest, skip, N // p, False)
    np.testing.assert_array_equal(got, payload * 10 + dest)


def test_route_apply_chunked_full_pass():
    """cap=None routes in p chunks of ceil(m/p) (buffers O(m), not O(p*m));
    every record sent to shard 0, every 17th skipped, answered exactly, as
    the JAX package's twin answers."""
    p, N = 8, 256
    rng = np.random.RandomState(13)
    payload = rng.randint(0, 1000, N).astype(np.int32)
    dest = np.zeros(N, np.int32)
    skip = np.zeros(N, bool)
    skip[::17] = True
    t_route.LAST_CHUNKED_ROUTE.clear()
    got = port(p, _echo, payload, dest, skip, None, False)
    np.testing.assert_array_equal(got, np.where(skip, 0, payload * 10))
    assert t_route.LAST_CHUNKED_ROUTE == dict(chunk=4, buf_rows=32, m=32)

    def inner(pay, dst, sk):
        def answer(recv, valid):
            (v,) = recv
            me = jax.lax.axis_index(AXIS).astype(jnp.int32)
            return (jnp.where(valid, v * 10 + me, -1),)
        return j_route.route_apply((pay,), dst, answer, (jnp.int32,), p,
                                   cap=None, skip=sk)[0]

    want = jax_run(p, inner, payload, dest, skip, out_specs=P(AXIS))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [9, 12, 40])
def test_route_apply_chunked_ragged(m):
    """Record counts that do not divide by p (the last chunks padded or
    empty) at p = 8."""
    p = 8
    rng = np.random.RandomState(m)
    payload = rng.randint(0, 1000, m * p).astype(np.int32)
    dest = rng.randint(0, p, m * p).astype(np.int32)
    skip = rng.rand(m * p) < 0.2
    got = port(p, _echo, payload, dest, skip, None, False)
    np.testing.assert_array_equal(got, np.where(skip, 0, payload * 10 + dest))


def test_route_apply_overflow_count():
    """At a forced small capacity the dropped records answer 0 and their
    psum'd count is that of the JAX package's twin."""
    p, N, cap = 4, 64, 3
    rng = np.random.RandomState(17)
    payload = rng.randint(0, 1000, N).astype(np.int32)
    dest = (rng.rand(N) < 0.7).astype(np.int32)  # skewed towards shard 1
    skip = np.zeros(N, bool)
    got, ovf = port(p, _echo, payload, dest, skip, cap, True)

    def inner(pay, dst, sk):
        def answer(recv, valid):
            (v,) = recv
            me = jax.lax.axis_index(AXIS).astype(jnp.int32)
            return (jnp.where(valid, v * 10 + me, -1),)
        return j_route.route_apply((pay,), dst, answer, (jnp.int32,), p,
                                   cap=cap, skip=sk, with_overflow=True)

    (want,), want_ovf = jax_run(p, inner, payload, dest, skip,
                                out_specs=((P(AXIS),), P()))
    assert ovf == int(want_ovf) > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [2, 8])
def test_route_scatter(p):
    N = 8 * p
    s = N // p
    rng = np.random.RandomState(11)
    target = rng.randint(0, 5, N).astype(np.int32)
    dest_idx = rng.choice(N, size=2 * p, replace=False).astype(np.int32)
    vals = (100 + np.arange(2 * p)).astype(np.int32)
    valid = np.ones(2 * p, bool)
    valid[3] = False

    def fn(ctx, tgt, di, v, vd):
        return t_route.route_scatter(di, (v,), (tgt,), vd, ctx=ctx)[0]

    got = port(p, fn, target, dest_idx, vals, valid)
    want = target.copy()
    want[dest_idx[valid]] = vals[valid]
    np.testing.assert_array_equal(got, want)
    jwant = jax_run(p, lambda tgt, di, v, vd: j_route.route_scatter(
        di, (v,), (tgt,), vd, s, p)[0], target, dest_idx, vals, valid,
        out_specs=P(AXIS))
    np.testing.assert_array_equal(got, jwant)


def test_route_scatter_slots_and_combine():
    """(row, slot) writes into a width-3 table and the min / max reducing
    scatters, with repeated places, at p = 4 against numpy."""
    p, rows, width = 4, 32, 3
    rng = np.random.RandomState(12)
    m = 8 * p
    dest = rng.randint(0, rows, m).astype(np.int32)
    slots = rng.randint(0, width, m).astype(np.int32)
    vals = rng.randint(0, 100, m).astype(np.int32)
    valid = rng.rand(m) < 0.8
    base = np.full(rows * width, 50, np.int32)

    def fn(ctx, tgt, di, v, vd, sl):
        outs = []
        for how in ("min", "max"):
            outs += t_route.route_scatter(di, (v,), (tgt,), vd, width=width,
                                          slots=sl, combine=(how,), ctx=ctx,
                                          cap=m // p)
        return tuple(outs)

    got = port(p, fn, base, dest, vals, valid, slots)
    for g, red in zip(got, (np.minimum, np.maximum)):
        want = base.copy()
        red.at(want, dest[valid] * width + slots[valid], vals[valid])
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("m", [8, 37, 96])
def test_route_scatter_chunked_equals_one_pass(monkeypatch, m):
    """Without a bound (``cap=None``) ``route_scatter`` routes in p chunks
    of ceil(m / p), the exchange's rows O(m) and not O(p*m) (m records a
    shard, ragged ones padded), and writes what one pass at cap = m
    writes: a "set" of distinct (row, slot) places into a width-3 table,
    and the min / max scatters with repeated places, at p = 4, with the
    overflow count 0."""
    p, rows, width = 4, 128, 3
    rng = np.random.RandomState(m)
    places = rng.choice(rows * width, size=m * p, replace=False)
    dest, slots = (places // width).astype(np.int32), \
        (places % width).astype(np.int32)
    vals = rng.randint(0, 100, m * p).astype(np.int32)
    valid = rng.rand(m * p) < 0.8
    base = np.full(rows * width, 50, np.int32)
    rep = rng.randint(0, rows, m * p).astype(np.int32)  # repeated rows
    exchanged = []
    exchange = t_route._exchange

    def counted(xs, cap, ctx):
        exchanged.append(xs[0].shape[0])
        return exchange(xs, cap, ctx)

    monkeypatch.setattr(t_route, "_exchange", counted)

    def fn(ctx, tgt, di, v, vd, sl, rp):
        outs, ovfs = [], []
        for cap in (None, di.shape[0]):
            for how, d in (("set", di), ("min", rp), ("max", rp)):
                (out,), ovf = t_route.route_scatter(
                    d, (v,), (tgt,), vd, width=width, slots=sl,
                    combine=(how,), ctx=ctx, cap=cap, with_overflow=True)
                outs.append(out)
                ovfs.append(int(ovf))
        return tuple(outs) + (Rep(ovfs),)

    *got, ovfs = port(p, fn, base, dest, vals, valid, slots, rep)
    assert ovfs == [0] * 6
    for a, b in zip(got[:3], got[3:]):
        np.testing.assert_array_equal(a, b)
    want = base.copy()
    want[dest[valid] * width + slots[valid]] = vals[valid]
    np.testing.assert_array_equal(got[0], want)
    for g, red in zip(got[1:3], (np.minimum, np.maximum)):
        want = base.copy()
        red.at(want, rep[valid] * width + slots[valid], vals[valid])
        np.testing.assert_array_equal(g, want)
    chunk = -(-m // p)
    # each shard: 3 chunked scatters of p passes at p * chunk rows, and 3
    # one-pass scatters at p * m rows
    assert sorted(exchanged) == sorted([p * chunk] * p * 3 * p +
                                       [p * m] * 3 * p)


@pytest.mark.parametrize("name", sorted(cases.BUCKET_CASES))
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_bucket_plain_vs_jax(p, name):
    """The plain bucketing (K12's plain version) gives each record the
    buffer position the JAX package's ``_bucket_by_dest`` gives it
    (its (order, flat_pos) written as positions in record order), in the
    same dtype, and its overflow count; a case without a skipped record
    passes no mask."""
    dest, skip, cap = cases.bucket_case(name, p)
    sk = skip if skip.any() else None
    pos, ovf = t_route._bucket_by_dest(
        torch.from_numpy(dest), p, cap,
        None if sk is None else torch.from_numpy(sk))
    order, _, j_ovf, flat = j_route._bucket_by_dest(
        jnp.asarray(dest), p, cap, None if sk is None else jnp.asarray(sk))
    want = np.empty(dest.shape[0], np.asarray(flat).dtype)
    want[np.asarray(order)] = np.asarray(flat)
    assert pos.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(pos.numpy(), want)
    assert ovf.dtype == torch.int32 and ovf.dim() == 0
    assert int(ovf) == int(np.asarray(j_ovf).sum())
    if name.startswith("overflow") or name == "one_shard":
        assert int(ovf) > 0


def test_bucket_plain_int64_positions():
    """Where p * cap reaches 2^31 the positions are int64 (the drop slot
    p * cap among them), as the JAX package's under x64."""
    p, cap = 4, 1 << 30
    dest = torch.tensor([3, 0, 3, 1, 2, 3], dtype=torch.int32)
    skip = torch.tensor([False, False, True, False, False, False])
    pos, ovf = t_route._bucket_by_dest(dest, p, cap, skip)
    assert pos.dtype == torch.int64 and int(ovf) == 0
    assert pos.tolist() == [3 * cap, 0, p * cap, cap, 2 * cap, 3 * cap + 1]


# ---------------------------------------------------------------------------
# bulk range minima
# ---------------------------------------------------------------------------

def _bulk(ctx, x, l, r, valid, cap):
    rmq = build_local_rmq(x)
    sm = t_col.shard_minima(x, ctx)
    out, ovf = bulk_rmq_local(rmq, sm, l, r, valid, ctx, cap=cap,
                              with_overflow=True)
    return out, Rep(int(ovf))


def test_bulk_rmq_capacity_overflow_retry():
    """Every range inside shard 0: capacity 8 overflows and says so (as the
    JAX package's twin counts), cap=None answers exactly."""
    from psac_tpu.ops.rmq import build_local_rmq as j_build
    from psac_tpu.parallel.par_rmq import bulk_rmq_local as j_bulk

    N, p, q = 512, 8, 64
    s = N // p
    rng = np.random.RandomState(13)
    x = rng.randint(0, 1000, N).astype(np.int32)
    ls = rng.randint(0, s // 2, q).astype(np.int32)
    rs = (ls + rng.randint(0, s // 2, q)).astype(np.int32)
    lrep, rrep = np.tile(ls, p), np.tile(rs, p)
    valid = np.ones(q * p, bool)

    def inner(x_l, l, r):
        rmq = j_build(x_l, with_small=False)
        return j_bulk(rmq, j_col.shard_minima(x_l, p), l, r,
                      jnp.ones((q,), bool), s, p, cap=8, with_overflow=True)

    _, want_ovf = jax_run(p, inner, x, lrep, rrep,
                          out_specs=(P(AXIS), P()))
    _, ovf = port(p, _bulk, x, lrep, rrep, valid, 8)
    assert ovf == int(want_ovf) > 0
    mins, ovf = port(p, _bulk, x, lrep, rrep, valid, None)
    assert ovf == 0
    want = np.array([x[a:b + 1].min() for a, b in zip(ls, rs)])
    np.testing.assert_array_equal(mins, np.tile(want, p))


@pytest.mark.parametrize("p", [3, 4])
def test_bulk_rmq_random_ranges(p):
    """Ranges inside one shard, crossing one edge and spanning shards,
    invalid queries INF, against numpy."""
    s, q = 32, 40
    N = s * p
    rng = np.random.RandomState(p)
    x = rng.randint(0, 10**6, N).astype(np.int64)
    lo = rng.randint(0, N, q * p)
    hi = np.minimum(N - 1, lo + rng.choice([0, 3, 20, 2 * s], q * p))
    valid = rng.rand(q * p) < 0.9
    mins, ovf = port(p, _bulk, x, lo.astype(np.int64), hi.astype(np.int64),
                     valid, None)
    want = np.array([x[a:b + 1].min() if v else np.iinfo(np.int64).max
                     for a, b, v in zip(lo, hi, valid)])
    np.testing.assert_array_equal(mins, want)


def test_rmq_mins_plain_on_cpu():
    """K6's min-only entry takes its plain version on CPU tensors: range
    minima, INF where not valid, a reversed range read as [lo, lo]."""
    x = torch.from_numpy(np.random.RandomState(4).randint(0, 99, 512)
                         .astype(np.int32))
    rmq = build_local_rmq(x)
    lo = torch.tensor([0, 5, 100, 7, 300], dtype=torch.int32)
    hi = torch.tensor([511, 5, 400, 2, 301], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, False])
    before = rmq_mins.launches
    got = rmq_mins(rmq, lo, hi, valid)
    assert rmq_mins.launches == before
    want = query_local_rmq(rmq, lo, torch.maximum(hi, lo))
    want[4] = 2**31 - 1
    assert torch.equal(got, want.to(torch.int32))


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

def test_worker_error_raises_in_the_caller():
    """Rank 1 raises while the others wait in a collective: the barrier is
    broken, ``run`` raises rank 1's error within seconds, and the mesh runs
    the next call."""
    mesh = make_mesh(4, ["cpu"] * 4)

    def fn(ctx, x):
        if ctx.rank == 1:
            raise ValueError("shard 1 failed")
        return ctx.psum(x.sum())

    xs = mesh.shard(torch.arange(16))
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="shard 1 failed"):
        mesh.run(fn, xs)
    assert time.perf_counter() - t0 < 10
    got = mesh.run(lambda ctx, x: Rep(int(ctx.psum(x.sum()))), xs)
    assert got == 120
    mesh.close()


def test_p1_runs_in_the_callers_thread():
    mesh = make_mesh(1, ["cpu"])
    out = mesh.run(lambda ctx, x: (x + ctx.rank, Rep(threading.get_ident())),
                   mesh.shard(torch.arange(4)))
    assert out[1] == threading.get_ident()
    assert torch.equal(out[0].gather(), torch.arange(4))
    assert num_shards(mesh) == 1 and num_shards(None) == 1


def test_make_mesh_never_guesses_a_device():
    """Without cards and without ``devices``, ``make_mesh(4)`` raises; the
    device list must have p entries."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has four cards")
    with pytest.raises(ValueError, match="CUDA device"):
        make_mesh(4)
    with pytest.raises(ValueError, match="devices given"):
        make_mesh(2, ["cpu"])


def test_replicated_outputs_must_agree():
    mesh = make_mesh(2, ["cpu"] * 2)
    with pytest.raises(AssertionError, match="replicated"):
        mesh.run(lambda ctx, x: Rep(ctx.rank), mesh.shard(torch.arange(4)))


def test_replicate_and_dataclass_arguments():
    """``Mesh.replicate`` holds one copy per shard; a dataclass argument of
    ``Mesh.run`` reaches each shard with its ``Sharded`` fields as the
    shard's block (a ``Replicated`` one as its copy) and its other fields
    as they are, and one without a sharded field as itself."""
    import dataclasses

    from psac_tpu_torch.parallel.mesh import Replicated

    @dataclasses.dataclass
    class Box:
        block: object
        copy: object
        tag: str

    mesh = make_mesh(3, ["cpu"] * 3)
    x = torch.arange(12)
    rep = mesh.replicate(torch.tensor([7, 8]))
    assert isinstance(rep, Replicated) and rep.p == 3 and len(rep) == 2
    assert torch.equal(rep.gather(), torch.tensor([7, 8]))
    got = mesh.run(lambda ctx, b: b.block + b.copy.sum() + ctx.rank
                   + (0 if b.tag == "t" else 100), Box(mesh.shard(x), rep,
                                                       "t"))
    assert torch.equal(got.gather(),
                       x + 15 + torch.arange(3).repeat_interleave(4))
    plain = Box(1, 2, "u")
    assert mesh.run(lambda ctx, b: Rep(b is plain), plain) is True
    mesh.close()
