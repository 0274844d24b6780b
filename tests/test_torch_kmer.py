"""The k-mer init of SA+LCP and of the GSA: K9 (``ops.kmer.kmer_pack``)
and K10 (``ops.kmer.kmer_heads``), ``psac_tpu_torch/csrc/kmer_init.cu``.

A numpy model of each kernel's per-thread arithmetic (K9: the block's
window of codes with the halo read through its own pointer, split into
phases, each thread's run of R positions on a k-char shift register, the
GSA's masks from each position's cut, the pad rank mod 2^32, at the built
shape and at the sweep's others; K10: ``clz`` and the floored quotient as
the kernel computes it from C's truncating ``/`` and ``%``)
and the wrappers on CPU tensors (their plain versions) are held against
the JAX package on the same seeded inputs (``verify.cases.kmer_init_case``):
``psac_tpu.ops.kmer.pack_kmers_local`` with the init's pad-rank select,
the GSA init's masked pack, ``psac_tpu.ops.bitops.lcp_bitwise_words``
with its lcp0 rules, shard by shard at p = 1, 2 and 4, including shards
shorter than k - 1 and int64 indexes.  The whole init of the port
(``_Builder._init``, ``_GsaBuilder._ginit``, on a thread mesh of CPU
shards) is held against the JAX package's jitted init at p = 1, 2 and 4.
Exact equality (integers only).  The kernels against their plain versions
on the card: ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psac_tpu.models.suffix_array import _x64_ctx
from psac_tpu.ops.bitops import lcp_bitwise_words as j_lcp_words
from psac_tpu.ops.kmer import pack_kmers_local as j_pack
from psac_tpu_torch.ops import kmer as t_kmer
from psac_tpu_torch.tools import k9_sweep
from psac_tpu_torch.verify.cases import (KMER_CASES, kmer_case,
                                         kmer_heads_inputs, kmer_pack_inputs)

torch.set_num_threads(1)

I64 = {False: torch.int32, True: torch.int64}
#: the run lengths R of tools/k9_sweep.py's variants (the sweep holds
#: each against the plain version on the card)
K9_SWEEP_RUNS = sorted({d["PSAC_K9_RUN"] for d in k9_sweep.variants().values()})


# ---------------------------------------------------------------- models


def _k9_row_stride(R: int, T: int) -> int:
    """row_stride() of csrc/kmer_init.cu: at least T + KP_MAX columns,
    32 / R banks apart."""
    p = T + (93 - 1 + R - 1) // R
    while p % 32 != (32 // R) % 32:
        p += 1
    return p


#: an entry of the model's shared memory that no thread stored
_POISON = np.uint64(1 << 40)


def _k9_model(codes, halo, ks, bits, base, N, eos=None,
              R=t_kmer.K9_RUN, T=t_kmer.K9_THREADS):
    """csrc/kmer_init.cu::pack_kernel, block by block, all T threads of a
    block at once.  The window starts delta chars before the block;
    thread t stores its chars t + m * T (m < R) and, of the R * kp chars
    of the tail, e = t + j * T (j < TAIL_ROUNDS), each at (a % R) * PS + a // R, read as
    window_code reads them (codes, the halo, then 0); every other entry
    stays poisoned, and the model asserts that no thread reads one.  The
    GSA's cut clamp(g + k - eos, 0, k) is staged where the block position
    lies inside the shard (the rest poisoned, asserted unread where a word
    is stored).  Then per thread the k-char shift register of the words
    (each word shifted by a char, the next word's top char or the new char
    in, its mask), fed kp * R chars (the full build of the run's first
    position), then R chars with the words taken after each: masked on a
    copy (shift of ~0 by max(cut * bits - bits after the word, 0), 0 from
    32 on), the pad rank N - g mod 2^32 where word 0 is 0."""
    s, k, nw = len(codes), sum(ks), len(ks)
    codes64 = codes.astype(np.uint64)
    halo64 = halo.astype(np.uint64)
    delta = (R - (k - 1) % R) % R
    kp = (k - 1 + delta) // R
    ps = _k9_row_stride(R, T)
    step = T // R
    # TAIL_ROUNDS: rounds of the T threads over the tail at the longest k
    tail_rounds = -(-R * ((93 - 1 + R - 1) // R) // T)
    m32 = np.uint64(0xFFFFFFFF)
    mask = [np.uint64((1 << (kw * bits)) - 1) for kw in ks]
    top = [np.uint64((kw - 1) * bits) for kw in ks]
    after = [bits * sum(ks[w + 1:]) for w in range(nw)]
    b64 = np.uint64(bits)
    words = [np.zeros(s, np.int32) for _ in ks]

    def window_code(gi):
        out = np.zeros(len(gi), np.uint64)
        own = (gi >= 0) & (gi < s)
        out[own] = codes64[gi[own]]
        hal = (gi >= s) & (gi - s < k - 1)
        out[hal] = halo64[gi[hal] - s]
        return out

    def roll(reg, c):
        assert not (c == _POISON).any(), "a read of an unloaded window entry"
        for w in range(nw):
            new = reg[w + 1] >> top[w + 1] if w + 1 < nw else c
            reg[w] = ((reg[w] << b64) | new) & mask[w]

    t = np.arange(T)
    dst = (t % R) * ps + t // R
    for first in range(0, s, T * R):
        g0 = first - delta
        win = np.full(R * ps, _POISON, np.uint64)
        for m in range(R):
            win[dst + m * step] = window_code(g0 + t + m * T)
        for j in range(tail_rounds):
            e = t + j * T
            on = e < R * kp
            win[dst[on] + T + j * step] = window_code(g0 + R * T + e[on])
        # block position q at (q % R) * T + q // R
        cut = np.full(R * T, -1, np.int64)
        if eos is not None:
            for m in range(R):
                p = first + t + m * T
                on = p < s
                c = base + p[on] + k - eos[p[on]].astype(np.int64)
                cut[(t[on] % R) * T + t[on] // R + m * step] = np.clip(c, 0,
                                                                      k)
        cut = cut.reshape(R, T)
        i0 = first + R * t
        live = i0 < s
        reg = [np.zeros(T, np.uint64) for _ in ks]
        for c in range(kp):
            for f in range(R):
                roll(reg, np.where(live, win[f * ps + t + c], 0))
        for f in range(R):
            roll(reg, np.where(live, win[f * ps + t + kp], 0))
            at = live & (i0 + f < s)
            o = list(reg)
            if eos is not None:
                assert (cut[f][at] >= 0).all(), "a read of an unstaged cut"
                for w in range(nw):
                    sh = np.maximum(cut[f] * bits - after[w], 0)
                    keep = np.where(sh >= 32, np.uint64(0),
                                    (m32 << np.minimum(sh, 31).astype(
                                        np.uint64)) & m32)
                    o[w] = o[w] & keep
            g = (base + i0 + f).astype(np.int64)
            pad = (np.int64(N) - g).astype(np.uint64) & m32
            o[-1] = np.where(o[0] == 0, pad, o[-1])
            for w in range(nw):
                words[w][i0[at] + f] = o[w][at].astype(np.uint32).view(
                    np.int32)
    return tuple(words)


def _clz32(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.int64) & 0xFFFFFFFF
    out = np.full(len(u), 32, np.int64)
    nz = u > 0
    out[nz] = 31 - np.floor(np.log2(u[nz].astype(np.float64))).astype(
        np.int64)
    return out


def _c_floor_div(a: np.ndarray, b: int) -> np.ndarray:
    """floor_div of the kernel: C's truncating quotient, less one where
    the remainder is not 0 and a < 0."""
    q = np.sign(a) * (np.abs(a) // b)
    r = a - q * b
    return np.where((r != 0) & (a < 0), q - 1, q)


def _k10_lcp(words, halo, ks, bits, div=_c_floor_div):
    """The per-word part of csrc/kmer_init.cu::heads_kernel: (head, the
    chained bitwise LCP) of each row against the row before."""
    s = len(words[0])
    head = np.zeros(s, bool)
    live = np.ones(s, bool)
    lcp = np.zeros(s, np.int64)
    for w, (cur, kw) in enumerate(zip(words, ks)):
        prev = np.concatenate([[halo[w]], cur[:-1]]).astype(np.int32)
        x = prev ^ cur
        head |= x != 0
        lw = np.where(x == 0, kw, div(_clz32(x) - (32 - kw * bits), bits))
        lcp = lw if w == 0 else np.where(live, lcp + lw, lcp)
        live &= x == 0
    return head, lcp


def _k10_model(words, halo, ks, bits, base, N, n_real, with_lcp, rem=None,
               rem_halo=None, idt=np.int32):
    """csrc/kmer_init.cu::heads_kernel, one row a thread."""
    s = len(words[0])
    head, lcp = _k10_lcp(words, halo, ks, bits)
    if not with_lcp:
        return head, None
    g = base + np.arange(s, dtype=np.int64)
    v = lcp
    if rem is not None:
        pr = np.concatenate([[rem_halo[0]], rem[:-1]]).astype(np.int64)
        v = np.minimum(np.minimum(v, pr), rem)
    v = np.where(head, v, N)
    if rem is None:
        v = np.where(g < N - n_real, g, v)
    return head, np.where(g == 0, 0, v).astype(idt)


# ------------------------------------------------ the JAX package's rules


def _jax_pack(codes, halo, ks, bits, base, N, idt, eos=None):
    """The JAX init's pack (``_init_local`` / ``_ginit_local``) of one
    shard: ``pack_kmers_local`` or the masked loop, then the pad rank."""
    s = len(codes)
    win = jnp.asarray(np.concatenate([codes, halo]))
    gidx = (base + jnp.arange(s, dtype=jnp.int32)).astype(idt)
    if eos is None:
        words = list(j_pack(win, s, ks, bits))
    else:
        e = jnp.asarray(eos.astype(idt))
        words = []
        off = 0
        for kw in ks:
            w = jnp.zeros((s,), jnp.int32)
            for j in range(off, off + kw):
                c = jnp.where(gidx + j < e, win[j:j + s], 0)
                w = (w << bits) | c
            words.append(w)
            off += kw
    pad_rank = (jnp.asarray(N, idt) - gidx).astype(jnp.int32)
    words[-1] = jnp.where(words[0] == 0, pad_rank, words[-1])
    return tuple(np.asarray(w) for w in words)


def _jax_heads(words, halo, ks, bits, base, N, n_real, idt, rem=None,
               rem_halo=None):
    """The JAX init's heads and lcp0 of one shard of sorted rows."""
    s = len(words[0])
    wsort = tuple(jnp.asarray(w) for w in words)
    prevs = tuple(jnp.concatenate([jnp.asarray(halo[j:j + 1]), w[:-1]])
                  for j, w in enumerate(wsort))
    newb = wsort[0] != prevs[0]
    for w, pw in zip(wsort[1:], prevs[1:]):
        newb = newb | (w != pw)
    gidx = (base + jnp.arange(s, dtype=jnp.int32)).astype(idt)
    lcpv = j_lcp_words(prevs, wsort, ks, bits).astype(idt)
    if rem is None:
        lcp0 = jnp.where(newb, lcpv, jnp.asarray(N, idt))
        lcp0 = jnp.where(gidx < jnp.asarray(N, idt) - n_real, gidx, lcp0)
    else:
        rs = jnp.asarray(rem.astype(idt))
        prev_rem = jnp.concatenate([jnp.asarray(rem_halo.astype(idt)),
                                    rs[:-1]])
        lcpv = jnp.minimum(jnp.minimum(lcpv, prev_rem), rs)
        lcp0 = jnp.where(newb, lcpv, jnp.asarray(N, idt))
    lcp0 = jnp.where(gidx == 0, jnp.asarray(0, idt), lcp0)
    return np.asarray(newb), np.asarray(lcp0)


# ------------------------------------------------------------ the cases


def _jidt(int64: bool):
    return jnp.int64 if int64 else jnp.int32


def _packed(case, p: int, idt):
    """Every shard's words from the plain wrapper, concatenated."""
    parts = [t_kmer.kmer_pack(torch.from_numpy(codes),
                              torch.from_numpy(halo), case["ks"],
                              case["bits"], b, case["N"], idt,
                              None if eos is None
                              else torch.from_numpy(eos).to(idt))
             for b, codes, halo, eos in kmer_pack_inputs(case, p)]
    return [torch.cat([w[j] for w in parts]).numpy()
            for j in range(len(case["ks"]))]


def _sorted_shards(case, p: int, idt):
    return kmer_heads_inputs(case, _packed(case, p, idt), p)


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("name", sorted(KMER_CASES))
def test_k9_model_and_plain_vs_jax(name):
    c, case = kmer_case(name)
    idt = I64[c["int64"]]
    jidt = _jidt(c["int64"])
    ks, bits, N = case["ks"], case["bits"], case["N"]
    with _x64_ctx(jidt):
        for b, codes, halo, eos in kmer_pack_inputs(case, c["p"]):
            want = _jax_pack(codes, halo, ks, bits, b, N, jidt, eos)
            model = _k9_model(codes, halo, ks, bits, b, N, eos)
            before = t_kmer.kmer_pack.launches
            got = t_kmer.kmer_pack(
                torch.from_numpy(codes), torch.from_numpy(halo), ks, bits, b,
                N, idt, None if eos is None else torch.from_numpy(eos).to(idt))
            assert t_kmer.kmer_pack.launches == before  # CPU: plain version
            assert len(got) == len(want) == len(model) == len(ks)
            for j, (g, m, w) in enumerate(zip(got, model, want)):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(m, w, err_msg=f"model {j}")
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"plain {j}")


@pytest.mark.parametrize("name", sorted(KMER_CASES))
def test_k10_model_and_plain_vs_jax(name):
    c, case = kmer_case(name)
    idt = I64[c["int64"]]
    jidt = _jidt(c["int64"])
    ks, bits, N, n = case["ks"], case["bits"], case["N"], case["n"]
    npdt = np.int64 if c["int64"] else np.int32
    edges_equal = 0
    with _x64_ctx(jidt):
        for b, words, halo, rs, rh in _sorted_shards(case, c["p"], idt):
            if b and all(h == w[0] for h, w in zip(halo, words)):
                edges_equal += 1
            want_b, want_l = _jax_heads(words, halo, ks, bits, b, N, n, jidt,
                                        rs, rh)
            assert want_l.dtype == npdt
            for with_lcp in (True, False):
                mb, ml = _k10_model(words, halo, ks, bits, b, N, n, with_lcp,
                                    rs, rh, npdt)
                before = t_kmer.kmer_heads.launches
                gb, gl = t_kmer.kmer_heads(
                    [torch.from_numpy(w) for w in words],
                    torch.from_numpy(halo), ks, bits, b, N,
                    0 if rs is not None else n, idt, with_lcp,
                    None if rs is None else torch.from_numpy(rs).to(idt),
                    None if rh is None else torch.from_numpy(rh).to(idt))
                assert t_kmer.kmer_heads.launches == before
                assert gb.dtype == torch.bool
                np.testing.assert_array_equal(mb, want_b)
                np.testing.assert_array_equal(gb.numpy(), want_b)
                if not with_lcp:
                    assert gl is None and ml is None
                    continue
                assert gl.dtype == idt
                np.testing.assert_array_equal(ml, want_l)
                np.testing.assert_array_equal(gl.numpy(), want_l)
    if c["p"] > 1 and c["N"] >= 1024:
        # runs of equal k-mers cover the shard edges
        assert edges_equal == c["p"] - 1


@pytest.mark.parametrize("name", ["k5-gsa-p1", "k5-sa-p2", "dna3-sa-p1"])
def test_floored_lcp_before_the_rules(name):
    """The bitwise LCP before the lcp0 rules, where the numerator is
    negative: at row 0 (the fill -1) and, at k5 with a pad of 70, between
    pad ranks above the last word's six bits.  There C's truncating
    quotient differs from JAX's floored one; the kernel's floor_div equals
    it.  (The rules then overwrite row 0 and, in the SA, the padding rows,
    and the GSA caps those rows by their remaining length 0.)"""
    c, case = kmer_case(name)
    ks, bits = case["ks"], case["bits"]
    inner = 0  # rows past row 0 where the two quotients differ
    for b, words, halo, _, _ in _sorted_shards(case, c["p"], torch.int32):
        prevs = tuple(jnp.concatenate([jnp.asarray(halo[j:j + 1]),
                                       jnp.asarray(w[:-1])])
                      for j, w in enumerate(words))
        want = np.asarray(j_lcp_words(prevs, tuple(map(jnp.asarray, words)),
                                      ks, bits))
        np.testing.assert_array_equal(_k10_lcp(words, halo, ks, bits)[1],
                                      want)
        trunc = _k10_lcp(words, halo, ks, bits,
                         lambda a, d: np.sign(a) * (np.abs(a) // d))[1]
        differs = np.flatnonzero(trunc != want)
        if b == 0:
            assert 0 in differs
        inner += int((b + differs > 0).sum())
    assert (inner > 0) == name.startswith("k5")


def test_cases_reach_the_edges_they_are_named_for():
    """The short shards are shorter than k - 1; the GSA strings end inside
    k-mer windows; the int31 codes fill 31 bits.  K9's runs: a string ends
    at every offset of a run of R positions, at every R of the sweep; the
    ragged shards are a multiple of no R, the tiny ones shorter than any;
    the blocks3 cases hold three whole blocks of K9's largest (8192
    positions) and a ragged fourth; at k = 93 (bin3) the window's tail
    past a block's own positions is longer than the block's threads, so
    the kernel loads it in more than one round."""
    c, case = kmer_case("dna3-sa-short")
    assert c["N"] // c["p"] < sum(case["ks"]) - 1
    _, case = kmer_case("dna2-gsa-p1")
    ends = np.unique(case["eos"][:case["n"]])
    assert (np.diff(ends) < sum(case["ks"])).sum() >= 5
    _, case = kmer_case("int31-sa-p1")
    assert case["codes"].max() >= 1 << 30
    _, case = kmer_case("dna3-gsa-runs")
    ends = np.unique(case["eos"][:case["n"]])
    ends = ends[ends < case["n"]]
    for R in K9_SWEEP_RUNS:
        assert set((ends % R).tolist()) == set(range(R)), R
    c, _ = kmer_case("bytes-sa-ragged")
    assert all((c["N"] // c["p"]) % r for r in K9_SWEEP_RUNS)
    c, _ = kmer_case("k5-gsa-tiny")
    assert all(c["N"] // c["p"] < r for r in K9_SWEEP_RUNS)
    for name in ("dna2-sa-blocks3", "dna2-gsa-blocks3-int64"):
        c, _ = kmer_case(name)
        assert c["p"] == 1 and c["N"] // 8192 == 3 and c["N"] % 8192
    c, case = kmer_case("bin3-sa-p1")
    k, R = sum(case["ks"]), t_kmer.K9_RUN
    assert k == 93 and c["N"] >= R * t_kmer.K9_THREADS
    assert k - 1 + (R - (k - 1) % R) % R > t_kmer.K9_THREADS


def test_k9_shape_is_the_built_one():
    """ops/kmer.py's K9_RUN and K9_THREADS, which the model takes, are the
    kernel's compiled defaults."""
    import os
    import re

    from psac_tpu_torch.ops import cuda_lib

    src = open(os.path.join(cuda_lib.CSRC_DIR, "kmer_init.cu")).read()
    got = {m: int(re.search(rf"#define {m} (\d+)", src).group(1))
           for m in ("PSAC_K9_RUN", "PSAC_K9_THREADS")}
    assert got == {"PSAC_K9_RUN": t_kmer.K9_RUN,
                   "PSAC_K9_THREADS": t_kmer.K9_THREADS}


def _jax_init(case, p, int64: bool, mesh_fn):
    from psac_tpu.models import gsa as j_gsa
    from psac_tpu.models import suffix_array as j_sa

    jidt = _jidt(int64)
    ks, bits, N, n = case["ks"], case["bits"], case["N"], case["n"]
    mesh = mesh_fn(p)
    with _x64_ctx(jidt):
        if case["eos"] is None:
            b = j_sa._Builder(mesh, N, ks, bits, True, idt=jidt)
            out = b._init(jnp.asarray(case["codes"]), n)
        else:
            b = j_gsa._GsaBuilder(mesh, N, ks, bits, True, idt=jidt)
            out = b._init(jnp.asarray(case["codes"]),
                          jnp.asarray(case["eos"].astype(jidt)))
        return [np.asarray(jax.device_get(x)) for x in out]


@pytest.mark.parametrize("name,p", [("dna2-sa-p1", 1), ("dna2-sa-p4", 4),
                                    ("k5-gsa-p2", 2), ("dna2-gsa-p4", 4),
                                    ("int31-sa-p2-int64", 2)])
def test_whole_init_vs_jax(name, p):
    """The port's init (K9, the sort, K10, the rebucket) on a thread mesh
    of p CPU shards against the JAX package's jitted init on p devices:
    isa, sa, lcp0, bucket rows, active mask (and the GSA's eos_row)."""
    from psac_tpu.parallel.mesh import make_mesh as j_make_mesh
    from psac_tpu_torch.models.gsa import _GsaBuilder
    from psac_tpu_torch.models.suffix_array import _Builder
    from psac_tpu_torch.parallel.mesh import make_mesh

    c, case = kmer_case(name)
    idt = I64[c["int64"]]
    ks, bits, N, n = case["ks"], case["bits"], case["N"], case["n"]
    want = _jax_init(case, p, c["int64"], j_make_mesh)
    mesh = make_mesh(p, devices=["cpu"] * p) if p > 1 else None
    codes = torch.from_numpy(case["codes"])

    def put(t):
        return mesh.shard(t) if mesh is not None else t

    if case["eos"] is None:
        b = _Builder(N, ks, bits, True, idt, "cpu", mesh=mesh)
        got = b._init_local(put(codes), n)
        outs, counts = got[:5], got[5]
    else:
        b = _GsaBuilder(N, ks, bits, True, idt, "cpu", mesh=mesh)
        got = b._ginit_local(put(codes), put(torch.from_numpy(
            case["eos"]).to(idt)))
        outs, counts = got[:6], got[6]
    for k, (g, w) in enumerate(zip(outs, want)):
        g = torch.cat(g.shards) if hasattr(g, "shards") else g
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {k}")
    jc = [int(x) for x in want[len(outs):]]
    tc = [int(x.value) if hasattr(x, "value") else int(x) for x in counts]
    assert tc == jc
