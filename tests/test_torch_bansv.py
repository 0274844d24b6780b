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
from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.ops.nsv_scan import _min_table, _prev_lt
from psac_tpu_torch.verify.cases import psv_adversaries

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


# ---------------------------------------------------------------------------
# numpy model of csrc/bansv.cu: a doubling min-table over each tile's
# window, binary lifting, then a warp climb by ballot for what lies before
# ---------------------------------------------------------------------------

def _hit(a, v, strict):
    return a < v if strict else a <= v


def _kernel_model(x, strict, lanes=32, wave=3):
    """K5's arithmetic on a numpy array, with the block width, tile and
    warp width of ``t_bansv.KERNEL_BLOCK``, ``KERNEL_TILE`` and ``lanes``,
    the tiles split into at most ``wave`` runs of consecutive tiles (one
    thread block each).  Every read is asserted to be in bounds (the levels
    inside the wrapper's scratch, every table entry holding the range of
    the window position it is read for, every block descended into full).
    Returns (psv, stats): stats counts the in-window answers, the climbers
    by the level where they found their block, and the levels descended."""
    B, T = t_bansv.KERNEL_BLOCK, t_bansv.KERNEL_TILE
    assert T % B == 0
    s = len(x)
    inf = np.iinfo(x.dtype).max
    levels = [x]
    while len(levels[-1]) > B:
        a = levels[-1]
        pad = np.concatenate([a, np.full(-len(a) % B, inf, x.dtype)])
        levels.append(pad.reshape(-1, B).min(axis=1))
    assert [len(a) for a in levels[1:]] == cuda_lib.level_sizes(s, B)
    W, LOG = 2 * T, (2 * T).bit_length() - 1
    out = np.empty(s, np.int64)
    stats = {"window": 0, "climbed": 0, "none": 0, "found_at_level": {},
             "descended": 0}

    def read(k, j):
        assert 0 <= j < len(levels[k]), (k, j)
        return levels[k][j]

    def load_run(k, top, lo):
        """load_run: a block's entries from its end, ``lanes`` a read."""
        return {j: read(k, j) for j in range(lo, top + 1)}

    def last_hit(ent, top, lo, v):
        """last_hit: one ballot per ``lanes`` entries from the end."""
        for r in range(-(-B // lanes)):
            m = [lo <= j < top + 1 and _hit(ent[j], v, strict)
                 for j in range(top - lanes * r, top - lanes * (r + 1), -1)]
            if any(m):
                return top - lanes * r - m.index(True)
        return -1

    def warp_climb(p, vals):
        """warp_climb for the climbing lanes' values ``vals`` (lane order):
        one region load per level shared by every lane, its minimum picks
        the lanes found there; then each found lane descends."""
        e = [-1] * len(vals)
        kf = [0] * len(vals)
        open_ = set(range(len(vals)))
        k = 1
        while k < len(levels) and open_:
            lo = p // B * B
            if p > lo:
                ent = load_run(k, p - 1, lo)
                rmin = min(ent.values())
                found = sorted(c for c in open_ if _hit(rmin, vals[c], strict))
                for c in found:
                    e[c] = last_hit(ent, p - 1, lo, vals[c])
                    assert e[c] >= 0
                    kf[c] = k
                    stats["found_at_level"][k] = stats["found_at_level"].get(
                        k, 0) + 1
                open_ -= set(found)
            p //= B
            k += 1
        for c in range(len(vals)):
            if c in open_:
                continue
            for lev in range(kf[c] - 1, -1, -1):
                first = e[c] * B
                # a full block, wholly before the window
                assert first + B <= (s if lev == 0 else len(levels[lev]))
                ent = load_run(lev, first + B - 1, first)
                e[c] = last_hit(ent, first + B - 1, first, vals[c])
                assert e[c] >= 0
                stats["descended"] += 1
        return e

    # the table: a ring of two tiles per level, tile q in slots (q & 1) * T
    # onwards; every entry carries the global index where its range starts
    tab = np.zeros((LOG, W), np.int64)
    tag = np.full((LOG, W), -(1 << 62), np.int64)  # never a real start

    def slot(b, j):
        return (j + ((b - 1) & 1) * T) & (W - 1)

    def entry(b, k, j):
        """tab[k][slot(b, j)], asserted to hold min(w[j .. j + 2^k))."""
        assert ((0 <= j) & (j + (1 << k) <= W)).all()
        sl = slot(b, j)
        assert (tag[k, sl] == b * T - T + j).all(), (b, k, j)
        return tab[k, sl]

    def put(b, k, j, val):
        sl = slot(b, j)
        tab[k, sl], tag[k, sl] = val, b * T - T + j

    def elem(i):
        return np.where((i >= 0) & (i < s), x[np.clip(i, 0, s - 1)], inf)

    nt = -(-s // T)
    per_block = -(-nt // wave)
    t = np.arange(T)
    for c0 in range(0, nt, per_block):  # one thread block each
        for b in range(c0, min(c0 + per_block, nt)):
            base = b * T
            if b == c0:  # stage and build the whole window
                j = np.arange(W)
                put(b, 0, j, elem(base - T + j))
                for k in range(1, LOG):
                    w = 1 << (k - 1)
                    j = np.arange(W - (1 << k) + 1)
                    put(b, k, j, np.minimum(entry(b, k - 1, j),
                                            entry(b, k - 1, j + w)))
            else:  # stage tile b; per level the T entries reaching into it
                put(b, 0, T + t, elem(base + t))
                for k in range(1, LOG):
                    w = 1 << (k - 1)
                    j = T - (1 << k) + 1 + t
                    put(b, k, j, np.minimum(entry(b, k - 1, j),
                                            entry(b, k - 1, j + w)))
            v = elem(base + t)
            lob = 0 if b > 0 else T
            # the lifting on ring positions r = p + off, unmasked: every
            # step loads (masked into the table); a kept step's entry
            # must hold its range
            off = ((b - 1) & 1) * T
            r = T + t + off
            for k in range(LOG - 1, -1, -1):
                c = r - (1 << k)
                m = tab[k, c & (W - 1)]
                ok = c >= lob + off
                assert (m[ok] == entry(b, k, c[ok] - off)).all()
                r = np.where(ok & ~_hit(m, v, strict), c, r)
            at = r - off - 1
            ans = np.where(at >= lob, base - T + at, -1)
            ws = base - T
            valid = base + t < s
            need = valid & (at < lob) & (ws > 0)
            stats["window"] += int((valid & (at >= lob)).sum())
            stats["climbed"] += int(need.sum())
            for warp0 in range(0, T, lanes):
                todo = [u for u in range(warp0, warp0 + lanes) if need[u]]
                if todo:
                    for u, e in zip(todo, warp_climb(ws // B, v[todo])):
                        ans[u] = e
            n = min(T, s - base)
            out[base:base + n] = ans[:n]
    stats["none"] = int((out < 0).sum())
    return out.astype(np.int32), stats


def _as(a, dt):
    a = a.astype(np.int64)
    if dt == np.int64:
        a = a * (1 << 33) - (1 << 40)
    return a.astype(dt)


# (B, TILE, lanes, wave): shrunk so that small inputs reach every level,
# and the kernel's own widths; one run of tiles for all, a few, one per tile
_GEOMETRIES = [(4, 4, 4, 1), (4, 8, 2, 3), (8, 16, 4, 10**9),
               (256, 256, 32, 3)]


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("geom", _GEOMETRIES,
                         ids=lambda g: "B%d_T%d_w%d_runs%d" % g)
def test_kernel_model_vs_plain(geom, dt, strict, monkeypatch):
    """The model against the plain version at sizes below, at and across
    TILE, 2 TILE, B^2 and B^3 (capped at the kernel's widths)."""
    B, T, lanes, wave = geom
    monkeypatch.setattr(t_bansv, "KERNEL_BLOCK", B)
    monkeypatch.setattr(t_bansv, "KERNEL_TILE", T)
    sizes = {1, T - 1, T, T + 1, 2 * T, 2 * T + 1, 3 * T + 5, B * B + 1}
    if B < 16:  # at the kernel's widths, B^2 is test_kernel_model_vs_jax's
        sizes |= {B * B - 1, B * B, B**3 - 1, B**3 + 1, B**4 + 3}
    levels_seen = set()
    for n in sorted(z for z in sizes if z > 0):
        for name, a in psv_adversaries(n, seed=n).items():
            a = _as(a, DTYPES[dt])
            got, st = _kernel_model(a, strict, lanes, wave)
            want = t_bansv.block_psv_plain(torch.from_numpy(a), strict)
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=f"{name}{n}")
            levels_seen |= set(st["found_at_level"])
    if B < 16:  # every level above 0 is where some climb found its block
        assert levels_seen >= {1, 2, 3}, levels_seen


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel_model_vs_jax(dt, strict):
    """The model at the kernel's own widths against the JAX ``block_psv``
    on the adversaries, across two superblocks."""
    for n in (257, 70000):
        for name, a in psv_adversaries(n, seed=7 + n).items():
            a = _as(a, DTYPES[dt])
            got, st = _kernel_model(a, strict)
            with _x64_ctx(jnp.int64 if dt == "int64" else jnp.int32):
                want = np.asarray(_J_PSV(jnp.asarray(a), strict))
            np.testing.assert_array_equal(got, want, err_msg=f"{name}{n}")
            if name == "decreasing":
                # every element past the first two tiles climbs, in vain
                assert st["climbed"] == max(0, n - 2 * t_bansv.KERNEL_TILE)
                assert st["none"] == n and st["window"] == 0


def test_kernel_model_far_minimum_descends_every_level(monkeypatch):
    """A far global minimum: the last elements climb to the top level and
    descend through every level below it."""
    monkeypatch.setattr(t_bansv, "KERNEL_BLOCK", 4)
    monkeypatch.setattr(t_bansv, "KERNEL_TILE", 4)
    a = psv_adversaries(4**4 + 9, seed=3)["far_min"].astype(np.int32)
    got, st = _kernel_model(a, True, lanes=4)
    np.testing.assert_array_equal(
        got, t_bansv.block_psv_plain(torch.from_numpy(a), True).numpy())
    top = len(cuda_lib.level_sizes(len(a), 4))
    assert max(st["found_at_level"]) == top
    assert st["descended"] >= top * st["found_at_level"][top]


def test_k5_sass_walks_one_tile_loop_without_climbs(tmp_path):
    """``tools/k5_sass.py`` on a made-up listing: it picks the int32 strict
    kernel, follows its tile loop and jumps over the climb after the
    loop's first vote."""
    from psac_tpu_torch.tools import k5_sass

    def fn(name, body):
        return [f"\t\tFunction : _ZN7psv{name}EEv"] + [
            f"        /*{16 * i:04x}*/                   {t} ;"
            for i, t in enumerate(body)]

    head, tail = 2, 67
    body = (["MOV R1, c[0x0][0x28]", "S2R R0, SR_TID.X", "LDS R2, [R3]",
             "VOTE.ANY R4, PT, P0", f"@!P0 BRA 0x{16 * 66:x}"]
            + ["SHFL.IDX PT, R5, R5, R6, 0x1f"] * 61
            + ["STG.E desc[UR4][R6.64], R7", f"@P1 BRA 0x{16 * head:x}",
               "EXIT", f"BRA 0x{16 * (tail + 2):x}"])
    other = fn("_kernelIlLb1E", ["MOV R1, R2", "EXIT"])
    path = tmp_path / "listing.txt"
    path.write_text("\n".join(other + fn("_kernelIiLb1E", body)))
    ins = k5_sass.kernel_listing(path.read_text())
    assert k5_sass.no_climb_path(ins) == [
        "LDS R2, [R3]", "VOTE.ANY R4, PT, P0", f"@!P0 BRA 0x{16 * 66:x}",
        "STG.E desc[UR4][R6.64], R7", f"@P1 BRA 0x{16 * head:x}"]
