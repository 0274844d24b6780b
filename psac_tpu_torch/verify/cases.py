"""Seeded inputs for checking the previous-smaller pass (K5), the LCP
resolve (K6), the walks (K8), the k-mer init (K9, K10), the DESA's pattern
encoding (K11), the routing's bucketing (K12) and the generalized suffix
array, shared by the CPU tests, the GPU tests and ``chip_smoke.py``
so that all three drive the same cases."""

from __future__ import annotations

import numpy as np

from psac_tpu_torch.ops.alphabet import rand_dna
from psac_tpu_torch.parallel.route import _TILE as _K12_TILE


def near_identical_family(count: int, length: int, subs: int,
                          seed: int = 7) -> list[bytes]:
    """One seeded random DNA sequence and ``count - 1`` copies with ``subs``
    seeded point substitutions each: a collection of near-identical
    genomes.  Nearly every suffix stays active after the k-mer init, so a
    GSA build runs its dense eos-masked loop, K6 in every step, and the
    tie-fix."""
    base = np.frombuffer(rand_dna(length, seed=seed), np.uint8)
    rng = np.random.RandomState(seed)
    dna = np.frombuffer(b"ACGT", np.uint8)
    out = [base.tobytes()]
    for _ in range(count - 1):
        a = base.copy()
        a[rng.randint(0, length, subs)] = dna[rng.randint(0, 4, subs)]
        out.append(a.tobytes())
    return out


def twin_prefix_set(prefixes=(700, 300, 150, 90),
                    seed: int = 1) -> list[bytes]:
    """Fourteen random 4 KiB strings (unique after the k-mer init) and, for
    each P, two strings that share their first P characters: the active
    count then falls step by step (2 * (P - c) suffixes of a pair still tie
    after c characters), through the dense loop and both tail stages of a
    GSA build."""
    out = [rand_dna(4096, seed=seed + i) for i in range(14)]
    for i, p in enumerate(prefixes):
        base = rand_dna(p, seed=seed + 100 + i)
        out += [base + b"A" + rand_dna(20, seed=seed + 200 + i),
                base + b"C" + rand_dna(20, seed=seed + 300 + i)]
    return out


def resolve_queries(s: int, m: int, block: int, L: int, seed: int):
    """``m`` seeded LCP-resolve queries on distinct rows of an (s,) LCP that
    mix one-element, narrow (under 8 wide), in-block, cross-block,
    whole-array and boundary ranges (starting on a block or 8 edge, ending
    at s - 1, two adjacent blocks with nothing between).  Returns int64
    numpy arrays (rows, lo, hi, j), j in 1..L-1."""
    rng = np.random.RandomState(seed)
    rows = rng.permutation(s)[:m]
    lo = rng.randint(0, s, m)
    kind = np.arange(m) % 8
    width = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
        [0, rng.randint(0, 8, m), rng.randint(0, block, m),
         rng.randint(block, 3 * block, m), rng.randint(0, s, m)],
        rng.randint(0, s, m))
    hi = np.minimum(lo + width, s - 1)
    b = lo // block * block
    lo = np.where(kind == 5, b, lo)
    hi = np.where(kind == 5, np.minimum(b + 2 * block - 1, s - 1), hi)
    lo = np.where(kind == 6, lo // 8 * 8, lo)
    hi = np.where(kind == 6,
                  np.minimum(lo + 7 + 8 * (np.arange(m) % 3), s - 1), hi)
    hi = np.where(kind == 7, s - 1, hi)
    lo[0], hi[0] = 0, s - 1
    lo[1], hi[1] = block - 1, block
    lo[2], hi[2] = s - 1, s - 1
    j = rng.randint(1, L, m) if L > 2 else np.ones(m, np.int64)
    return rows, lo, hi, j


def wide_resolve_queries(s: int, m: int, block: int, L: int, seed: int):
    """``m`` seeded LCP-resolve queries on distinct rows, seven in eight of
    them 8 or more wide: inside a block, across two or three blocks, across
    up to 64 blocks and up to the whole array; the rest under 8 wide.
    Returns int64 numpy arrays (rows, lo, hi, j), j in 1..L-1."""
    rng = np.random.RandomState(seed)
    rows = rng.permutation(s)[:m]
    lo = rng.randint(0, s, m)
    kind = np.arange(m) % 8
    width = np.select(
        [kind == 0, kind <= 2, kind <= 4, kind <= 6],
        [rng.randint(0, 8, m), rng.randint(8, max(9, block), m),
         rng.randint(block, 3 * block, m), rng.randint(3 * block,
                                                       64 * block, m)],
        rng.randint(8, s, m))
    hi = np.minimum(lo + width, s - 1)
    lo = np.minimum(lo, np.maximum(hi - 8, 0))  # wide to the end as well
    lo = np.where(kind == 0, hi - width, lo).clip(0)
    j = rng.randint(1, L, m) if L > 2 else np.ones(m, np.int64)
    return rows, lo, hi, j


def resolve_lcp(s: int, seed: int) -> np.ndarray:
    """A seeded (s,) int64 LCP-like array: ties within a few values, a level
    that changes every 64 elements (so block minima differ from block to
    block) and a few zeros."""
    rng = np.random.RandomState(seed)
    level = rng.randint(0, 20, s // 64 + 1).repeat(64)[:s]
    lcp = rng.randint(0, 50, s) + 100 * level
    lcp[rng.randint(0, s, s // 256 + 1)] = 0
    return lcp


def resolve_expected(lcp, rows, lo, hi, j, d: int) -> np.ndarray:
    """The resolved LCP by direct computation: ``j * d + min(lcp[lo..hi])``
    at each query's row, every other row unchanged."""
    out = np.array(lcp, np.int64)
    mins = np.minimum.reduceat(
        np.concatenate([out, [0]]), np.stack([lo, hi + 1], 1).reshape(-1))[::2]
    out[rows] = j * d + mins
    return out


def resolve_query_arrays(s: int, rows, lo, hi, j, inf: int) -> dict:
    """A dense step's (s,) int64 query arrays: ``inf`` keys and wild range
    and column values on the rows without a query."""
    rng = np.random.RandomState(5)
    q = dict(qkey=np.full(s, inf, np.int64), lq=rng.randint(-5, 2 * s, s),
             rq=rng.randint(-5, 2 * s, s), jcol=rng.randint(1, 4, s))
    for k, v in (("qkey", rows), ("lq", lo), ("rq", hi), ("jcol", j)):
        q[k][rows] = v
    return q


def psv_adversaries(n: int, seed: int) -> dict:
    """Length-n int64 inputs for the previous-smaller pass (K5): random
    values in [0, 2^16), a decreasing array (every element climbs to the
    top of the minima hierarchy, in vain), a far global minimum (the last
    elements climb to the top, then descend through every level), sparse
    tiny values in random data (a few climbers in many warps) and
    plateaus."""
    rng = np.random.RandomState(seed)
    far = rng.randint(10, 1000, n)
    far[min(3, n - 1)] = 0
    far[-max(1, n // 50):] = 1
    sparse = rng.randint(100, 1 << 16, n)
    hits = rng.randint(0, n, max(1, n // 300))
    sparse[hits] = rng.randint(0, 5, len(hits))
    return {"random": rng.randint(0, 1 << 16, n),
            "decreasing": n - np.arange(n, dtype=np.int64),
            "far_min": far, "sparse_tiny": sparse,
            "plateaus": np.repeat(rng.randint(0, 4, n // 7 + 1), 7)[:n]}


WALK_KINDS = ("random", "constant", "sorted", "reversed", "runs", "near")
#: offsets from a row's start of the ``near`` kind's fixed starts: the
#: edges of a 128-byte window of int32 (32 entries) and of int64 (16) and
#: the row's ends
NEAR_OFFSETS = (0, 1, 15, 16, 17, 31, 32, 33, 127, 128, 129)


def _prev_smaller(x: np.ndarray, at: np.ndarray, t: np.ndarray,
                  top: int) -> np.ndarray:
    """For each query k: the largest j <= at[k] with x[j] < t[k], -1 if
    none; x and t in [0, top]."""
    out = np.full(at.shape[0], -1, np.int64)
    idx = np.arange(x.shape[0])
    for c in range(top + 1):
        sel = (t == c) & (at >= 0)
        if sel.any():
            last = np.maximum.accumulate(np.where(x < c, idx, -1))
            out[sel] = last[at[sel]]
    return out


def _near_starts(x: np.ndarray, q: int, rng) -> tuple:
    """Starts and values as ``parallel/ansv.py::_left_furthest_eq`` makes
    them for its full-width walks, over LCP-like ``x`` in [0, 20]: for
    elements i in increasing order, j* = the previous strictly smaller,
    then (j* + 1, x[i]) (``e_loc``), (max(j*, 0) + 1, x[j*]) (``j0_l``)
    and (j0, x[j*]) with j0 one past the last element at or before j*
    smaller than x[j*] (``eh_l``), a third of the queries each."""
    n = x.shape[0]
    m = -(-q // 3)
    i = np.sort(rng.randint(0, n, m))
    jstar = _prev_smaller(x, i - 1, x[i], 20)
    jsafe = np.maximum(jstar, 0)
    v2 = x[jsafe]
    j0 = _prev_smaller(x, jsafe, v2, 20) + 1
    start = np.concatenate([jstar + 1, jsafe + 1, j0])
    v = np.concatenate([x[i], v2, v2])
    return start[:q], v[:q]


def walk_case(kind: str, n: int, dtype, q: int, seed: int):
    """(x, start, v) for the walks (K8): x of length n and ``dtype`` (int32,
    or int64 values below -2^31 and above 2^32), q int64 starts (the first
    three 0, n and the padded length n rounded up to 128, the rest in
    [0, padded]) and q query values: entries of x, one below and one above
    them, and the dtype's minimum and maximum (with which the padding
    qualifies for a non-strict compare).  The ``near`` kind is a shard's
    LCP as the ANSV's walks see it: values in [0, 20], most answers a few
    entries from the start; after the first three, starts at
    ``NEAR_OFFSETS`` from the first, a middle and the last row's start,
    then the full-width walks' starts and values in their order
    (``_near_starts``)."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        x = rng.randint(0, 1000, n)
    elif kind == "constant":
        x = np.full(n, 7)
    elif kind == "sorted":
        x = np.sort(rng.randint(0, 1000, n))
    elif kind == "reversed":
        x = np.sort(rng.randint(0, 1000, n))[::-1]
    elif kind == "runs":
        x = np.repeat(rng.randint(0, 6, -(-n // 37)), 37)[:n]
    elif kind == "near":
        x = np.minimum(rng.poisson(11, n), 20)
    else:
        raise ValueError(f"unknown walk case {kind!r}")
    x = x.astype(np.int64)
    padded = -(-n // 128) * 128
    if kind == "near":
        rows = np.array([0, padded // 256 * 128, padded - 128])
        fixed = np.concatenate([[0, n, padded], np.clip(
            (rows[:, None] + np.array(NEAR_OFFSETS)).ravel(), 0, padded)])
        fs, fv = _near_starts(x, max(0, q - fixed.shape[0]), rng)
        start = np.concatenate([fixed, fs])[:q]
        v = np.concatenate([x[rng.randint(0, n, fixed.shape[0])], fv])[:q]
    else:
        start = np.concatenate([[0, n, padded], rng.randint(
            0, padded + 1, max(0, q - 3))])[:q]
        v = x[rng.randint(0, n, q)] + rng.randint(-1, 2, q)
    step = 1
    if np.dtype(dtype) == np.int64:
        step = 1 << 33
        x = x * step - (1 << 40)
        v = v * step - (1 << 40)
    info = np.iinfo(dtype)
    v[rng.rand(q) < 0.02] = info.max
    v[rng.rand(q) < 0.02] = info.min
    return (np.ascontiguousarray(x.astype(dtype)), start.astype(np.int64),
            v.astype(dtype))


#: (bits per char, chars per word) of the k-mer init's cases: DNA at two and
#: three words, bytes, the IntAlphabet's widest codes, DNA with
#: ``SAConfig(k=5)`` (``kmer_words_for``: (3, 2)), and a one-symbol text
#: at one bit a char with ``SAConfig(kmer_words=3)`` (k = 93, the longest)
KMER_SHAPES = {
    "bin3": (1, (31, 31, 31)),
    "dna2": (3, (10, 10)),
    "dna3": (3, (10, 10, 10)),
    "bytes": (8, (3, 3)),
    "int31": (31, (1, 1)),
    "k5": (3, (3, 2)),
}


def kmer_init_case(shape: str, N: int, pad: int, gsa: bool, seed: int,
                   cut_all: bool = False):
    """Seeded inputs of the k-mer init at ``KMER_SHAPES[shape]``: (N,)
    int32 codes (1 .. 2^bits - 1) of a text of n = N - pad chars, zeros
    after it: a random twentieth, a twentieth of a repeated seven-char
    unit, then a run of the largest code, whose equal k-mers fill the last
    rows of the sort past the shard edges of p = 2 and 4.  With ``gsa`` the
    first tenth is cut into strings of 1-12 chars (most end inside a k-mer
    window), the run is one string, and ``eos`` is the (N,) int64 end of
    each position's string (g itself past n); with ``cut_all`` the whole
    text is cut so.  Returns dict(codes, eos (None without gsa), bits, ks,
    n, N)."""
    bits, ks = KMER_SHAPES[shape]
    rng = np.random.RandomState(seed)
    n = N - pad
    top = (1 << bits) - 1
    sigma = min(top, 4 if bits == 3 else 1 << 20)
    lo = 1 if bits < 31 else top - sigma
    codes = rng.randint(lo, lo + sigma, n).astype(np.int64)
    unit = rng.randint(lo, lo + sigma, 7)
    a, b = n // 20, n // 10
    codes[a:b] = np.resize(unit, b - a)
    codes[b:] = lo + sigma - 1
    out = np.zeros(N, np.int32)
    out[:n] = codes
    eos = None
    if gsa:
        eos = np.arange(N, dtype=np.int64)
        cut = n if cut_all else b
        start = 0
        while start < cut:
            end = min(cut, start + int(rng.randint(1, 13)))
            eos[start:end] = end
            start = end
        eos[cut:n] = n
    return dict(codes=out, eos=eos, bits=bits, ks=ks, n=n, N=N)


def _kmer_cases() -> dict:
    out = {}
    for shape in sorted(KMER_SHAPES):
        for gsa in (False, True):
            kind = "gsa" if gsa else "sa"
            for p in (1, 2, 4):
                # the k5 shape's pad of 70 puts pad ranks above its last
                # word's six bits
                out[f"{shape}-{kind}-p{p}"] = dict(
                    shape=shape, N=1024, pad=70 if shape == "k5" else 5,
                    gsa=gsa, p=p, int64=False)
    for gsa in (False, True):
        kind = "gsa" if gsa else "sa"
        for shape in ("dna2", "int31"):
            out[f"{shape}-{kind}-p2-int64"] = dict(
                shape=shape, N=1024, pad=5, gsa=gsa, p=2, int64=True)
        # s = 4 < k - 1 = 29: the halo spans the next blocks and the end
        out[f"dna3-{kind}-short"] = dict(shape="dna3", N=16, pad=3, gsa=gsa,
                                         p=4, int64=False)
        # two of K10's blocks of 256 rows and a ragged third
        out[f"dna2-{kind}-blocks"] = dict(shape="dna2", N=552, pad=9,
                                          gsa=gsa, p=1, int64=False)
    # K9's blocks of T * R positions: three whole ones at every shape of
    # tools/k9_sweep.py (at most 8192) and a ragged fourth
    out["dna2-sa-blocks3"] = dict(shape="dna2", N=3 * 8192 + 1000, pad=9,
                                  gsa=False, p=1, int64=False)
    out["dna2-gsa-blocks3-int64"] = dict(shape="dna2", N=3 * 8192 + 1000,
                                         pad=9, gsa=True, p=1, int64=True)
    # a string end at every offset of a thread's run of R positions
    out["dna3-gsa-runs"] = dict(shape="dna3", N=1000, pad=5, gsa=True, p=1,
                                int64=False, cut_all=True)
    # shards of s = 1001 (a multiple of no run length) and s = 3 < R
    out["bytes-sa-ragged"] = dict(shape="bytes", N=2002, pad=5, gsa=False,
                                  p=2, int64=False)
    out["k5-gsa-tiny"] = dict(shape="k5", N=12, pad=3, gsa=True, p=4,
                              int64=False, cut_all=True)
    return out


#: the k-mer init's cases by name: shape, N, pad, GSA or SA, shards p and
#: int64 indexes
KMER_CASES = _kmer_cases()


def kmer_case(name: str):
    """(parameters, ``kmer_init_case`` inputs) of ``KMER_CASES[name]``,
    seeded by the name."""
    c = KMER_CASES[name]
    return c, kmer_init_case(c["shape"], c["N"], c["pad"], c["gsa"],
                             seed=sum(map(ord, name)),
                             cut_all=c.get("cut_all", False))


def kmer_pack_inputs(case: dict, p: int) -> list:
    """K9's inputs on each of p shards: (base, codes, halo, eos), the halo
    the k - 1 codes right of the block, zeros past N (``halo_from_right``:
    whole blocks of several neighbours where k - 1 exceeds s)."""
    N, k = case["N"], sum(case["ks"])
    s = N // p
    padded = np.concatenate([case["codes"], np.zeros(k - 1, np.int32)])
    out = []
    for r in range(p):
        b = r * s
        eos = None if case["eos"] is None else case["eos"][b:b + s]
        out.append((b, case["codes"][b:b + s], padded[b + s:b + s + k - 1],
                    eos))
    return out


def kmer_heads_inputs(case: dict, words: list, p: int) -> list:
    """K10's inputs on each of p shards from the (N,) int32 ``words`` of
    every position: the rows sorted by (words, position) as the init's
    sort leaves them, cut into shards of (base, words, left halo (-1 at
    shard 0), rem, rem halo (0 at shard 0); rem and its halo None for the
    SA)."""
    N = case["N"]
    g = np.arange(N, dtype=np.int64)
    order = np.lexsort((g,) + tuple(reversed(words)))
    ws = [w[order] for w in words]
    rem = None if case["eos"] is None else (case["eos"] - g)[order]
    s = N // p
    out = []
    for r in range(p):
        b = r * s
        halo = np.array([w[b - 1] if r else -1 for w in ws], np.int32)
        rs = rh = None
        if rem is not None:
            rs = rem[b:b + s]
            rh = np.array([rem[b - 1] if r else 0], np.int64)
        out.append((b, [w[b:b + s] for w in ws], halo, rs, rh))
    return out


#: the DESA's pattern batches over ``PATTERN_TEXT``'s alphabet (ACGT), for
#: ``DESA.encode_patterns`` and K11: none and one pattern, an empty one,
#: bytes outside the alphabet, lengths across the lane groups' widths in
#: one batch, each bytes-like kind ``encode_patterns`` takes and, on the
#: card, a ``mkpattern`` batch of 65,536 x 20 bytes and a group at Lmax 256
PATTERN_TEXT = rand_dna(4096, seed=11)
PATTERN_CASES = ("none", "one", "empty", "all_empty", "outside",
                 "mixed_lengths", "bytearray", "memoryview", "strided_view",
                 "uint8_array", "int_list")
PATTERN_CASES_LARGE = ("mkpattern_65536x20", "lmax256")


def pattern_batch(name: str) -> list:
    """The seeded batch ``name`` of ``PATTERN_CASES`` or
    ``PATTERN_CASES_LARGE``: substrings of ``PATTERN_TEXT``."""
    t = PATTERN_TEXT
    rng = np.random.RandomState(len(name))

    def subs(lengths, rng=rng):
        return [t[s:s + ln] for ln, s in zip(
            lengths, rng.randint(0, len(t) - max(lengths), len(lengths)))]

    # the same mixed batch in every kind
    mixed = subs([1, 2, 31, 32, 33, 64, 200] * 3, np.random.RandomState(0))
    if name == "none":
        return []
    if name == "one":
        return subs([20])
    if name == "empty":
        return subs([5, 20]) + [b""] + subs([3])
    if name == "all_empty":
        return [b"", b""]
    if name == "outside":
        return subs([20, 7]) + [b"ACGN" + t[:16], b"\x00", b"\xff" * 3,
                                t[:31] + b"a", b"N"] + subs([1])
    if name == "mixed_lengths":
        return mixed + [b""]
    if name == "bytearray":
        return [bytearray(p) for p in mixed]
    if name == "memoryview":
        return [memoryview(p) for p in mixed]
    if name == "strided_view":
        return [memoryview(p + p)[::2] for p in mixed]
    if name == "uint8_array":
        return [np.frombuffer(p, np.uint8) for p in mixed]
    if name == "int_list":
        return [list(p) for p in mixed]
    if name == "mkpattern_65536x20":
        pos = rng.randint(0, len(t) - 20, 65536)
        return [t[s:s + 20] for s in pos]
    if name == "lmax256":
        return subs(list(rng.randint(129, 257, 3000)))
    raise KeyError(name)


#: K12's rows a block: the cases reach one tile exactly and one row past it
BUCKET_TILE = _K12_TILE
#: (m, skip share, cap) of the bucketing cases; cap None is m (no record
#: overflows), an int a cap the busiest destinations overflow
BUCKET_CASES = {
    "empty": (0, 0.0, None),
    "one": (1, 0.0, None),
    "one_skipped": (1, 1.0, None),
    "tile": (BUCKET_TILE, 0.1, None),
    "tile_plus_one": (BUCKET_TILE + 1, 0.0, None),
    "skip_none": (50_000, 0.0, None),
    "skip_10": (50_000, 0.1, None),
    "skip_90": (50_000, 0.9, None),
    "overflow": (50_000, 0.1, "tight"),
    "overflow_skip_90": (50_000, 0.9, "tight"),
    "one_shard": (30_000, 0.1, "tight"),
}


def bucket_case(name: str, p: int, seed: int = 5):
    """(dest int32, skip bool, cap) of a routing's bucketing at ``p``
    shards: uniform destinations (every record to shard p - 1 in
    ``one_shard``), a seeded share skipped, and at a "tight" cap 3/4 of an
    even share of the records not skipped, so the busiest destinations
    overflow."""
    m, share, cap = BUCKET_CASES[name]
    rng = np.random.RandomState(seed + 97 * p)
    if name == "one_shard":
        dest = np.full(m, p - 1, np.int32)
    else:
        dest = rng.randint(0, p, m).astype(np.int32)
    skip = rng.rand(m) < share if 0 < share < 1 else np.full(m, share == 1)
    if cap is None:
        cap = m
    else:
        cap = max(1, 3 * int((~skip).sum()) // (4 * p))
    return dest, skip, cap
